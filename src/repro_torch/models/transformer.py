"""Transformer blocks over a shared residual stream.

Mirrors ``repro.models.transformer`` for the block kinds ``attn+moe``,
``attn+dense``, ``mamba+moe`` and ``mamba+dense`` (attention GQA or MLA) on one device
(``ParallelCtx()``) or on a mesh of data x model ranks over
``torch.distributed`` (a ``ParallelCtx`` built by ``repro_torch.launch.
mesh.pctx_for_mesh``: the EP group is the mesh's model axis, the data
group its batch axis; a factored EP group of racks x lanes,
``collectives.factor``, is the mesh with a rack axis, and its MoE blocks
run ``hier_a2a``).  On a mesh the model takes the reference's layout
(``repro_torch.parallel.sharding``) for every step, training, prefill and
decode: attention and the dense FFN are tensor parallel over the model
axis, every large weight is FSDP over the data axis, each MoE block runs
the EP layer with its experts gathered over data, and the decode cache
holds the rank's block of positions (:func:`_block_apply_sharded`).  The
residual stream between blocks is each model rank's shard of the
sequence, or the whole sequence where it does not divide by the model
axis and at decode (``ParallelCtx.seq_whole``, the reference's ``wsc``).
JAX groups identical layers into scanned segments (and a hybrid's
repeating period into one "cycle" segment); here the layers are a Python
list and each block runs in turn.

The full forward (cache None) is differentiable on one device and on a
mesh (``repro_torch.train.loop`` reduces the gradients over it).  With
``RuntimeConfig.remat`` (on by default, as in the reference) each layer of
the full forward keeps only its input for the backward and runs again
inside it (``repro_torch.models.model.forward``; the serve paths never
remat).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.balancer import BalancerConfig
from repro_torch.core.topology import Topology
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import AttnConfig, KVCache
from repro_torch.models.layers import dense_swiglu, rms_norm
from repro_torch.models.ssm import SSMConfig, SSMState
from repro_torch.moe.gating import GatingConfig
from repro_torch.moe.layer import MoEConfig, default_capacities, init_moe_params
from repro_torch.parallel import collectives, sharding

__all__ = ["RuntimeConfig", "ParallelCtx", "BlockParams", "attn_config",
           "ssm_config", "effective_rack_limit", "moe_config", "init_block",
           "init_cache_block", "block_apply"]


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs orthogonal to the architecture (the subset of
    ``repro.models.transformer.RuntimeConfig`` this slice runs)."""

    balancer: BalancerConfig = BalancerConfig()
    cf_pair: float = 2.0
    cf_slot: float = 2.0
    distribute_chunks: int = 1     # reduce-scatters of the replica stream
    overlap_chunks: int = 1        # MoE dispatch/compute overlap chunks;
    # falls back to 1 per layer when the local token count does not divide
    # or the dispatch engine is "reference"
    dispatch_impl: str = "fused"   # "fused" | "reference" MoE dispatch engine
    rack_limit: int = 0            # bound each token's experts to this many
    # racks at the gate (0 = free routing); degrades to free routing on a
    # flat group and where the limit cannot hold (effective_rack_limit)
    block_kv: int = 512
    dtype: torch.dtype = torch.float32
    wire_dtype: str = "none"       # EP wire codec: "none" | "bf16" | "int8";
    # needs the fused engine, so it degrades to "none" with "reference"
    ffn_dtype: str = "none"        # expert FFN compute: "none" | "int8" (w8a8)
    remat: bool = True             # full forward: each layer recomputed in
    # the backward (torch.utils.checkpoint), its activations not kept
    loss_chunks: int = 1           # >1: blocked CE, no (B,S,V) materialise
    plain_backward: bool = False   # the kernels' backward as autograd through
    # their plain versions, the forward unchanged (a check of the backward
    # kernels in place); not in the reference


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Parallel context (mirrors ``repro.models.transformer.ParallelCtx``):
    ``group`` the EP group (a
    :class:`repro_torch.parallel.collectives.EPGroup`, factored into racks
    x lanes for a two-level topology) or None for one rank; ``data`` the
    data group (the ranks that hold this rank's experts, one a data row:
    ``batch_axes``' counterpart) or None when there is one data row;
    ``world`` every rank of the mesh (None: the EP group's ranks).  Rank
    numbering is the reference mesh's row-major order, global rank
    ``d * R + r``; a factored group is rack-major inside each data row, so
    its rank r holds flat rank r's experts.  ``mesh_axes``: the mesh's
    (axis name, size) pairs, which ``sharding.from_ctx`` reads; a context
    of more than one rank carries them and runs the reference's layout
    (:func:`block_apply`).  Per call: ``batch_replicated``: every data row
    holds the whole global batch, which does not divide over the data
    group (``sharding.batch_rows``; the train step sets it);
    ``seq_whole``: the residual stream is the whole sequence on every
    model rank, not its shard (a sequence that does not divide by the
    model axis, ``sharding.stream_whole``; the train step and the serving
    adapter set it, a decode step always runs so)."""

    group: object = None
    data: object = None
    world: object = None
    batch_replicated: bool = False
    seq_whole: bool = False
    mesh_axes: tuple = ()

    @property
    def ep_size(self) -> int:
        return 1 if self.group is None else self.group.size

    @property
    def racks(self) -> int:
        if self.group is None or not self.group.factored:
            return 1
        return self.group.racks

    @property
    def factored(self) -> bool:
        return self.group is not None and self.group.factored

    @property
    def ep_rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    @property
    def data_size(self) -> int:
        return 1 if self.data is None else self.data.size

    @property
    def data_rank(self) -> int:
        return 0 if self.data is None else self.data.rank

    @property
    def world_group(self):
        """Every rank of the mesh (the EP group when there is no data
        group, the data group when there is no EP group); None on one
        rank."""
        if self.world is not None:
            return self.world
        return self.group if self.group is not None else self.data

    @property
    def world_size(self) -> int:
        return self.ep_size * self.data_size

    @property
    def batch_size_divisor(self) -> int:
        return self.data_size


class BlockParams(nn.Module):
    """One residual block: norm1, mixer (attention ``attn`` or Mamba
    ``ssm``), norm2, FFN (dense (w1, w3, w2) or MoE)."""

    def __init__(self, norm1, norm2, attn, ffn=None, moe=None, ssm=None):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.norm2 = None if norm2 is None else nn.Parameter(
            norm2, requires_grad=False)
        self.attn = attn
        self.ssm = ssm
        self.ffn = None if ffn is None else nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in ffn])
        self.moe = moe

    def forward(self, x, kind, cfg, rcfg, pctx, **kw):
        return block_apply(x, self, kind, cfg, rcfg, pctx, **kw)


def attn_config(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                      causal=cfg.causal, qkv_bias=cfg.qkv_bias,
                      qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                      q_lora_rank=cfg.q_lora_rank,
                      kv_lora_rank=cfg.kv_lora_rank,
                      qk_nope_dim=cfg.qk_nope_dim,
                      qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim)


def ssm_config(cfg: ModelConfig) -> SSMConfig:
    s = cfg.ssm
    return SSMConfig(d_model=cfg.d_model, d_inner=s.d_inner,
                     headdim=s.headdim, d_state=s.d_state,
                     n_groups=s.n_groups, d_conv=s.d_conv, chunk=s.chunk)


def effective_rack_limit(m, rcfg: RuntimeConfig, racks: int) -> int:
    """The gate's rack limit as applied (mirrors ``repro.models.
    transformer.effective_rack_limit``): ``rcfg.rack_limit`` degrades to
    free routing (0) on a flat or one-rack group, where the experts do not
    divide into racks, and where the limit would expose fewer than top_k
    experts; else it is clamped to the rack count."""
    if rcfg.rack_limit <= 0 or racks <= 1 or m is None:
        return 0
    if m.num_experts % racks != 0:
        return 0
    limit = min(rcfg.rack_limit, racks)
    if limit * (m.num_experts // racks) < m.top_k:
        return 0
    return limit


def moe_config(cfg: ModelConfig, rcfg: RuntimeConfig, pctx: ParallelCtx,
               tokens_per_rank: int, *, dispatch_mode: str = "a2a",
               ideal: bool = False) -> MoEConfig:
    """Mirrors ``repro.models.transformer.moe_config`` on an EP group of
    ``pctx.ep_size`` ranks: on a factored group the gate's rack limit, the
    per-rack pair bound and ``hier_a2a`` in place of ``a2a``; overlap
    chunks that do not divide the tokens, or with the reference engine,
    degrade to 1, and the wire codec to "none" with the reference
    engine."""
    m = cfg.moe
    ep = pctx.ep_size
    rack_limit = effective_rack_limit(m, rcfg, pctx.racks)
    gating = GatingConfig(
        num_experts=m.num_experts, top_k=m.top_k, score_fn=m.score_fn,
        norm_topk_prob=m.norm_topk_prob, aux_loss_weight=m.aux_loss_weight,
        routed_scaling=m.routed_scaling, use_bias=m.use_bias,
        ideal=ideal or rcfg.balancer.mode == "ideal",
        rack_limit=rack_limit, num_racks=pctx.racks if rack_limit else 1)
    bal = dataclasses.replace(rcfg.balancer, n_slot=m.n_slot)
    slots_per_rank = m.num_experts // ep + m.n_slot
    topo = (Topology(racks=pctx.racks, ranks_per_rack=ep // pctx.racks)
            if pctx.factored and pctx.racks > 1 else None)
    cap_pair, cap_slot = default_capacities(
        tokens_per_rank, m.top_k, ep, slots_per_rank,
        cf_pair=rcfg.cf_pair, cf_slot=rcfg.cf_slot, topology=topo)
    if pctx.factored and dispatch_mode == "a2a":
        dispatch_mode = "hier_a2a"
    overlap = rcfg.overlap_chunks
    if overlap >= 1 and (tokens_per_rank % overlap != 0
                         or rcfg.dispatch_impl != "fused"):
        overlap = 1
    wire_dtype = rcfg.wire_dtype if rcfg.dispatch_impl == "fused" else "none"
    return MoEConfig(gating=gating, balancer=bal, d_model=cfg.d_model,
                     d_ff=m.d_ff, ep_size=ep, cap_pair=cap_pair,
                     cap_slot=cap_slot, n_shared_experts=m.n_shared_experts,
                     shared_d_ff=m.shared_d_ff, dispatch_mode=dispatch_mode,
                     dispatch_impl=rcfg.dispatch_impl, racks=pctx.racks,
                     distribute_chunks=rcfg.distribute_chunks,
                     overlap_chunks=overlap, wire_dtype=wire_dtype,
                     ffn_dtype=rcfg.ffn_dtype,
                     plain_backward=rcfg.plain_backward)


def init_block(cfg: ModelConfig, kind: str, rcfg: RuntimeConfig,
               pctx: ParallelCtx, generator: torch.Generator, *,
               device="cuda") -> BlockParams:
    mixer, ffn_kind = kind.split("+")
    D = cfg.d_model
    dtype = rcfg.dtype
    attn = ssm = ffn = moe = None
    if mixer == "attn":
        init = attn_mod.init_mla if cfg.is_mla else attn_mod.init_gqa
        attn = init(attn_config(cfg), generator, dtype=dtype, device=device)
    else:
        ssm = ssm_mod.init_ssm(ssm_config(cfg), generator, dtype=dtype,
                               device=device)
    if ffn_kind == "dense":
        Fd = cfg.d_ff
        ffn = tuple(
            torch.randn(shape, generator=generator, dtype=dtype,
                        device=device) * scale
            for shape, scale in (((D, Fd), D ** -0.5), ((D, Fd), D ** -0.5),
                                 ((Fd, D), Fd ** -0.5)))
    elif ffn_kind == "moe":
        mcfg = moe_config(cfg, rcfg, pctx, tokens_per_rank=8)  # caps unused
        moe = init_moe_params(mcfg, generator, dtype=dtype, device=device,
                              ep_rank=pctx.ep_rank)
    norm2 = None if ffn_kind == "none" else torch.ones(D, dtype=dtype,
                                                       device=device)
    return BlockParams(torch.ones(D, dtype=dtype, device=device), norm2,
                       attn, ffn=ffn, moe=moe, ssm=ssm)


def init_cache_block(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype, *, device="cuda",
                     pctx: ParallelCtx | None = None) -> KVCache | SSMState:
    """Decode cache entry for one layer: a KVCache for attention (MLA: the
    latent (B, S, kv_lora) and the rope key (B, S, rope)), an SSMState
    (fp32 state, conv tail in ``dtype``) for a Mamba mixer.  On a mesh
    (``pctx`` of more than one rank) the rank's shard of the reference's
    placement (``sharding.cache_specs``): the ``batch`` rows over the data
    axis where they divide, and an attention cache's ``max_seq`` positions
    over the model axis in contiguous blocks (every KV head, or the whole
    latent, on each rank); a Mamba state stays whole over the model axis,
    where the mixer runs whole."""
    length_rows = batch
    if pctx is not None and pctx.world_size > 1:
        T = pctx.ep_size
        if max_seq % T:
            raise ValueError(f"max_seq {max_seq} does not split over the "
                             f"model axis of {T}: the decode cache holds "
                             f"max_seq / {T} positions a rank")
        if not sharding.batch_replicated(pctx, batch):
            batch //= pctx.data_size
        max_seq //= T
        length_rows = batch
    length = torch.zeros(length_rows, dtype=torch.int64, device=device)
    if kind.startswith("attn+"):
        if cfg.is_mla:
            k_shape = (batch, max_seq, cfg.kv_lora_rank)
            v_shape = (batch, max_seq, cfg.qk_rope_dim)
        else:
            k_shape = v_shape = (batch, max_seq, cfg.num_kv_heads,
                                 cfg.head_dim)
        return KVCache(k=torch.zeros(k_shape, dtype=dtype, device=device),
                       v=torch.zeros(v_shape, dtype=dtype, device=device),
                       length=length)
    scfg = ssm_config(cfg)
    return SSMState(
        s=torch.zeros((batch, scfg.n_heads, scfg.d_state, scfg.headdim),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, scfg.d_conv - 1,
                          ssm_mod.conv_channels(scfg)), dtype=dtype,
                         device=device),
        length=length)


def block_apply(x: torch.Tensor, bp: BlockParams, kind: str, cfg: ModelConfig,
                rcfg: RuntimeConfig, pctx: ParallelCtx, *, cache=None,
                router_bias: torch.Tensor | None = None, decode: bool = False,
                valid_len=None):
    """One residual block.  Returns (x, aux, drops, counts, new_cache).

    Modes: full forward (cache None), chunked prefill (cache given, decode
    False), decode (cache given, decode True, S == 1).  On a mesh:
    :func:`_block_apply_sharded`.
    """
    if pctx.world_size > 1:
        return _block_apply_sharded(x, bp, kind, cfg, rcfg, pctx,
                                    cache=cache, router_bias=router_bias,
                                    decode=decode, valid_len=valid_len)
    mixer, ffn_kind = kind.split("+")
    dev = x.device
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.zeros(cfg.moe.num_experts if cfg.moe else 1,
                         dtype=torch.int64, device=dev)
    new_cache = cache

    h = rms_norm(x, bp.norm1)
    if mixer == "attn":
        # GQAParams or MLAParams: each sends the call to its own decode,
        # chunked prefill or full-sequence function.
        y = bp.attn(h, attn_config(cfg), cache=cache, decode=decode,
                    valid_len=valid_len, block_kv=rcfg.block_kv,
                    plain_backward=rcfg.plain_backward)
        if cache is not None:
            y, new_cache = y
    else:
        scfg = ssm_config(cfg)
        if decode:
            y, new_cache = ssm_mod.ssd_decode(h, cache, bp.ssm, scfg)
        elif cache is not None:
            y, new_cache = ssm_mod.ssd_prefill(h, cache, bp.ssm, scfg)
        else:
            y, _final = ssm_mod.ssd_forward(
                h, bp.ssm, scfg, plain_backward=rcfg.plain_backward)
    x = x + y

    if ffn_kind != "none":
        h2 = rms_norm(x, bp.norm2)
        if ffn_kind == "moe":
            B, S, D = x.shape
            mcfg = moe_config(cfg, rcfg, pctx, max(1, B * S),
                              dispatch_mode="replicated" if decode else "a2a")
            y2, aux, stats = bp.moe(h2.reshape(-1, D), mcfg,
                                    router_bias=router_bias)
            y2 = y2.reshape(B, S, D)
            drops, counts = stats.drops_dispatch + stats.drops_slot, \
                stats.counts
        else:
            y2 = dense_swiglu(h2, *bp.ffn)
        x = x + y2
    return x, aux, drops, counts, new_cache


# ------------------------------------------------- the sharded layout ----

def _seq_gather(h: torch.Tensor, pctx: ParallelCtx,
                whole: bool) -> torch.Tensor:
    """The whole sequence from every model rank's shard (B, S / T, ...)
    (Megatron's sequence-parallel entry: the backward reduce-scatters), or
    ``h`` itself on a ``whole`` stream."""
    return h if whole else collectives.gather_along(pctx.group, h, 1)


def _seq_exit(y: torch.Tensor, pctx: ParallelCtx, split: bool,
              whole: bool):
    """Back to the stream: the sum of the ranks' partial ``y`` (``split``:
    heads or FFN columns over the model axis; the partials in the model
    dtype, as the reference reduces them) reduce-scattered to this rank's
    sequence shard, or all-reduced onto a ``whole`` stream; a ``y`` every
    rank computed whole is cut to the rank's shard, or left as it is on a
    whole stream."""
    T = pctx.ep_size
    if split:
        if whole:
            return collectives.reduce_whole(pctx.group, y)
        return collectives.scatter_along(pctx.group, y, 1)
    if T == 1 or whole:
        return y
    n = y.shape[1] // T
    return y.narrow(1, pctx.ep_rank * n, n)


def _ssm_view(params, spec: dict, pctx: ParallelCtx):
    """The Mamba mixer's weights gathered whole (in_proj's model split
    mixes z, x, B, C and dt, not heads): every rank runs the whole
    mixer."""
    from types import SimpleNamespace

    return SimpleNamespace(**{n: sharding.use(getattr(params, n), spec[n],
                                              pctx, model=True)
                              for n in spec})


def _moe_view(mp, spec: dict, pctx: ParallelCtx):
    """The MoE weights one call computes with: the rank's experts gathered
    over the data axis into slot buffers of their own (FSDP; an expert
    weight the data axis does not split keeps its buffer), the router
    whole and the shared expert gathered whole, as the reference's island
    takes it."""
    from repro_torch.moe.layer import GatheredMoE

    mains, slots = [], []
    for n, buf in zip(("w1", "w3", "w2"), mp.slot_buffers()):
        w, sp = getattr(mp, n), (None,) + tuple(spec[n][1:])
        if pctx.data is None or all(e is None for e in sp):
            mains.append(w)
            slots.append(buf)
            continue
        whole = [s * (pctx.data.size if e is not None else 1)
                 for s, e in zip(w.shape, sp)]
        buf = w.new_zeros((whole[0] + mp.n_slot,) + tuple(whole[1:]))
        mains.append(sharding.use(w, sp, pctx, out=buf[:whole[0]]))
        slots.append(buf)
    shared = {n: None if getattr(mp, n) is None else sharding.use(
        getattr(mp, n), spec[n], pctx, model=True)
        for n in ("shared_w1", "shared_w3", "shared_w2")}
    return GatheredMoE(mp.router, *mains, **shared, n_slot=mp.n_slot,
                       slots=tuple(slots))


def _ep_moe_block_sharded(x, mp, spec, mcfg, pctx, router_bias, whole):
    """(B, S, D) -> (B, S, D): the EP layer on the stream as it is (the
    rank's sequence shard, or every token where the stream is whole:
    ``a2a`` (``hier_a2a`` on racks) with every model rank routing the same
    tokens, or at decode ``replicated``), with its experts gathered over
    the data axis; aux,
    drops and counts summed as the reference's island
    (``repro.models.transformer._ep_moe_block``) sums them: aux and drops
    over every rank of the mesh (each rank's aux is its own tokens' term;
    on a whole stream every model rank's is the same), counts over data x
    model (``replicated``: over the data axis, every model rank already
    counts every token).  Where the batch is replicated over the data
    group (``pctx.batch_replicated``) every data row holds the same
    values, and the sums run over the model group only, as the reference's
    island leaves the data axes out of them."""
    B, S, D = x.shape
    g = pctx.group
    y, aux, stats = _moe_view(mp, spec, pctx)(
        x.reshape(-1, D), mcfg, axis_name=g, router_bias=router_bias)
    if whole and mcfg.dispatch_mode != "replicated":
        # The reference's island declares its output replicated over the
        # model axis, but where items drop its copies differ by the
        # exchange's source order; the array's value is the first model
        # rank's copy, which every rank takes here.
        y = collectives.first_copy(g, y)
    world = g if pctx.batch_replicated else pctx.world_group
    data = None if pctx.batch_replicated else pctx.data
    drops = stats.drops_dispatch + stats.drops_slot
    counts = stats.counts
    if mcfg.dispatch_mode == "replicated":
        if world is not None:
            drops = collectives.all_reduce(world, drops)
            aux = collectives.all_reduce(world, aux)
        if data is not None:
            counts = collectives.all_reduce(data, counts)
    elif world is not None:
        summed = collectives.all_reduce(world, torch.cat([counts,
                                                          drops[None]]))
        counts, drops = summed[:-1], summed[-1]
        aux = collectives.all_reduce(world, aux)
    return y.reshape(B, S, D), aux, drops, counts


def _block_apply_sharded(x, bp, kind, cfg, rcfg, pctx, *, cache=None,
                         router_bias=None, decode=False, valid_len=None):
    """:func:`block_apply` on the reference's layout: ``x`` is this rank's
    sequence shard (B, S / T, D), T the model axis (the reference's
    ``wsc`` "seq" layout), or the whole sequence on every rank where the
    stream is whole (``pctx.seq_whole``, and every decode step), and the
    norms run on it.  A mixer gathers a shard's sequence at entry
    ("full"), runs on the rank's heads (attention) or whole (Mamba), and
    leaves by a reduce-scatter of wo's partial sums (an all-reduce onto a
    whole stream), or its slice of the whole output (all of it on a whole
    stream); the dense FFN is column-parallel w1 / w3 and row-parallel w2
    between the same two; the MoE block runs on the stream as it is.
    Every weight is gathered over the data axis at use (FSDP).  The decode
    cache is the rank's block of positions (``attention``'s sharded
    prefill and decode); a Mamba state stays whole.

    Gradients: a tensor every rank of the model group holds whole (the
    gathered sequence, a whole stream, a gathered weight) carries a part
    of its cotangent on each rank (``collectives``' notes), so a
    replicated parameter's gradient is a part too and is summed over the
    model axis (``sharding.lm_param_specs``)."""
    mixer, ffn_kind = kind.split("+")
    dev = x.device
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.zeros(cfg.moe.num_experts if cfg.moe else 1,
                         dtype=torch.int64, device=dev)
    new_cache = cache
    spec = sharding.block_layout(cfg, kind, pctx)
    whole = decode or pctx.seq_whole

    def sub(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in spec.items() if k.startswith(prefix)}

    h = _seq_gather(rms_norm(x, bp.norm1), pctx, whole)
    if mixer == "attn":
        acfg = attn_config(cfg)
        w, lcfg, split = attn_mod.tp_view(bp.attn, acfg, pctx, sub("attn."))
        if decode:
            dec = attn_mod.mla_decode_sharded if cfg.is_mla else \
                attn_mod.gqa_decode_sharded
            y, new_cache = dec(h, cache, w, acfg, lcfg, pctx, split)
        elif cache is not None:
            pre = attn_mod.mla_prefill_sharded if cfg.is_mla else \
                attn_mod.gqa_prefill_sharded
            y, new_cache = pre(h, cache, w, acfg, lcfg, pctx, split,
                               valid_len=valid_len, block_kv=rcfg.block_kv)
        else:
            full = attn_mod.mla_attention if cfg.is_mla else \
                attn_mod.gqa_attention
            y = full(h, w, lcfg, block_kv=rcfg.block_kv,
                     plain_backward=rcfg.plain_backward, project=False)
        y = y @ w.wo                 # row-parallel where split: partials
    else:
        scfg = ssm_config(cfg)
        w = _ssm_view(bp.ssm, sub("ssm."), pctx)
        split = False
        if decode:
            y, new_cache = ssm_mod.ssd_decode(h, cache, w, scfg)
        elif cache is not None:
            y, new_cache = ssm_mod.ssd_prefill(h, cache, w, scfg)
        else:
            y, _final = ssm_mod.ssd_forward(
                h, w, scfg, plain_backward=rcfg.plain_backward)
    x = x + _seq_exit(y, pctx, split, whole)

    if ffn_kind != "none":
        h2 = rms_norm(x, bp.norm2)
        if ffn_kind == "moe":
            B, S, D = x.shape
            # The reference sizes the capacities from its global B floored
            # by the data group, (B // D), and S over the model axis where
            # S is at least T (also where it does not divide: a mirror, not
            # a fix; the capacity then counts fewer tokens than a rank
            # routes).  A split batch leaves this rank B // D rows already;
            # a replicated one leaves all B.
            rows = B // pctx.batch_size_divisor if pctx.batch_replicated \
                else B
            T = pctx.ep_size
            per = S if not whole or decode or S < T else S // T
            mcfg = moe_config(cfg, rcfg, pctx, max(1, rows * per),
                              dispatch_mode="replicated" if decode
                              else "a2a")
            y2, aux, drops, counts = _ep_moe_block_sharded(
                h2, bp.moe, sub("moe."), mcfg, pctx, router_bias, whole)
        else:
            fs = [spec[f"ffn.{i}"] for i in range(3)]
            split = pctx.ep_size > 1 and sharding.on_model(fs[0][1])
            w1, w3, w2 = (sharding.use(wi, si, pctx, model=not split)
                          for wi, si in zip(bp.ffn, fs))
            # Column-parallel w1 / w3, row-parallel w2 (partial sums)
            # where the hidden dimension is split.
            y2 = _seq_exit(dense_swiglu(_seq_gather(h2, pctx, whole), w1,
                                        w3, w2), pctx, split, whole)
        x = x + y2
    return x, aux, drops, counts, new_cache

"""Placement of the parameters, the batch, the activations and the
optimizer state on a mesh.

Mirrors ``repro.parallel.sharding``, MaxText-style, one model axis:

* the ``model`` axis (``("rack", "model")`` on a factored mesh, the EP
  group as one): tensor parallelism of the attention heads and the FFN
  hidden dimension, expert parallelism of the experts, the vocabulary of
  the embedding and the logits, and the sequence of the residual stream
  between blocks;
* the batch axes (``data``, and ``pod`` on the multi-pod mesh; the port's
  data group, one entry): the batch rows, and FSDP of every large weight
  on a dimension that divides, so AdamW's moments, which take their
  parameter's shard shape, are ZeRO-sharded with it;
* small vectors (norms, biases, the SSM's per-head vectors) and the
  router are replicated.

A placement is plain data, one entry per tensor dimension: None, the model
axis (a name, or the factored axes' tuple) or the batch axes (a tuple).
:func:`param_layout` gives every parameter's by construction (the
reference's ``_gqa_specs`` ... ``lm_param_specs``, keyed by the port's
parameter names), from the mesh's axis sizes alone (:class:`MeshAxes`),
with no process group, and :func:`shard_shape` a rank's shard of a global
shape; every helper leaves a dimension that does not divide by its axis
replicated, as the reference's do.  :func:`batch_specs`,
:func:`opt_state_specs` and :func:`activation_spec` are the reference's
too, and so is :func:`cache_specs` (the decode cache: its positions over
the model axis, flash-decode).  On the ranks of a mesh, :func:`lm_param_specs`
turns each parameter's entries into a :class:`Placement`: the group each
dimension is split over, the group whose sum of the ranks' gradients is
the gradient (``reduce``) and the ranks holding the same values
(``replicas``).  AdamW's moments mirror the placements.

One layout for every step on a mesh (a ``ParallelCtx`` of more than one
rank, which carries its ``mesh_axes``): a parameter's gradient is summed
over the axes it is not split over (``reduce`` equals ``replicas``): the
blocks see a rank's shard of the sequence, or a head's share of a whole
one, so a replicated parameter's gradient is a part on every rank, and a
split one is whole after the reduce-scatter of its gather
(``repro_torch.models.transformer``'s notes).  The residual stream is the
rank's sequence shard where the sequence divides by the model axis, and
whole otherwise, a decode step among them (``ParallelCtx.seq_whole``, the
reference's ``wsc``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig, layer_kinds

__all__ = ["MeshAxes", "from_ctx", "topology_from_ctx", "param_layout",
           "batch_specs", "cache_specs", "opt_state_specs",
           "activation_spec", "shard_shape", "Placement", "batch_rows",
           "batch_replicated", "stream_whole", "local_batch", "lm_param_specs",
           "cut", "gather_whole", "shard_params_", "use", "block_layout",
           "lm_layout", "mesh_axes", "dims_of", "on_model"]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Axis names and sizes of a mesh (the reference's ``MeshAxes``):
    ``batch`` the batch axes, ``model`` the model axis or the factored
    ``("rack", "model")`` pair; ``sizes`` empty on one rank."""

    batch: tuple
    model: str | tuple
    sizes: dict

    def size_of(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.sizes[a] for a in axes)

    @property
    def batch_size(self) -> int:
        return self.size_of(self.batch)

    @property
    def model_size(self) -> int:
        return self.size_of(self.model)

    def div(self, n: int, axes) -> bool:
        return n % self.size_of(axes) == 0


def mesh_axes(shape: dict) -> MeshAxes:
    """The :class:`MeshAxes` of a mesh of axis sizes ``shape`` (the
    reference's ``pctx_for_mesh`` + ``from_ctx``: every axis but
    ``model`` and ``rack`` is a batch axis)."""
    sizes = {a: int(s) for a, s in shape.items()}
    batch = tuple(a for a in sizes if a not in ("model", "rack"))
    model = ("rack", "model") if "rack" in sizes else "model"
    return MeshAxes(batch=batch or ("data",), model=model, sizes=sizes)


def from_ctx(pctx) -> MeshAxes:
    """The axes of ``pctx``'s mesh (``ParallelCtx.mesh_axes``); a context
    of more than one rank must carry them (``launch.mesh.pctx_for_mesh``
    builds every such context)."""
    if pctx.world_size > 1 and not pctx.mesh_axes:
        raise ValueError("a ParallelCtx of more than one rank carries its "
                         "mesh's axes (launch.mesh.pctx_for_mesh)")
    return mesh_axes(dict(pctx.mesh_axes))


def topology_from_ctx(pctx, **link_kw):
    """The EP :class:`repro_torch.core.topology.Topology` of a mesh
    context (the reference's), from its axes: one rack of the model
    axis's ranks on a flat mesh, racks x lanes on a factored one (a
    ``rack`` axis); ``link_kw`` overrides the per-tier alpha / beta link
    model."""
    from repro_torch.core.topology import Topology

    ax = from_ctx(pctx)
    ep = ax.model_size if ax.sizes else pctx.ep_size
    if "rack" not in ax.sizes:
        return Topology.flat(ep, **link_kw)
    racks = ax.sizes["rack"]
    return Topology(racks=racks, ranks_per_rack=ep // racks, **link_kw)


def _mm(ax: MeshAxes, n: int):
    """The model axis if ``n`` divides by it, else None."""
    return ax.model if ax.sizes and ax.div(n, ax.model) else None


def _dd(ax: MeshAxes, n: int):
    """The batch axes (FSDP) if ``n`` divides by them, else None."""
    return ax.batch if ax.sizes and ax.div(n, ax.batch) else None


def _gqa_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    m_q, m_kv = _mm(ax, H * hd), _mm(ax, Hkv * hd)
    d_fs = _dd(ax, cfg.d_model)
    out = {"wq": (d_fs, m_q), "wk": (d_fs, m_kv), "wv": (d_fs, m_kv),
           "wo": (m_q, d_fs)}
    if cfg.qkv_bias:
        out.update(bq=(m_q,), bk=(m_kv,), bv=(m_kv,))
    if cfg.qk_norm:
        out.update(q_norm=(None,), k_norm=(None,))
    return out


def _mla_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    H = cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    d_fs = _dd(ax, cfg.d_model)
    return {"wq_a": (d_fs, _mm(ax, cfg.q_lora_rank)), "q_a_norm": (None,),
            "wq_b": (_dd(ax, cfg.q_lora_rank), _mm(ax, H * qk)),
            "wkv_a": (d_fs, None), "kv_a_norm": (None,),
            "wkv_b": (_dd(ax, cfg.kv_lora_rank),
                      _mm(ax, H * (cfg.qk_nope_dim + cfg.v_head_dim))),
            "wo": (_mm(ax, H * cfg.v_head_dim), d_fs)}


def _ssm_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    s = cfg.ssm
    cc = s.d_inner + 2 * s.n_groups * s.d_state
    proj_out = (2 * s.d_inner + 2 * s.n_groups * s.d_state
                + s.d_inner // s.headdim)
    return {"in_proj": (_dd(ax, cfg.d_model), _mm(ax, proj_out)),
            "conv_w": (None, _mm(ax, cc)), "conv_b": (_mm(ax, cc),),
            "a_log": (None,), "d_skip": (None,), "dt_bias": (None,),
            "norm": (None,),
            "out_proj": (_mm(ax, s.d_inner), _dd(ax, cfg.d_model))}


def _moe_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    m = cfg.moe
    d_fs, f_fs = _dd(ax, cfg.d_model), _dd(ax, m.d_ff)
    e = _mm(ax, m.num_experts)
    out = {"router": (None, None), "w1": (e, d_fs, None),
           "w3": (e, d_fs, None), "w2": (e, f_fs, None)}
    if m.n_shared_experts > 0:
        m_s = _mm(ax, m.shared_d_ff * m.n_shared_experts)
        out.update(shared_w1=(d_fs, m_s), shared_w3=(d_fs, m_s),
                   shared_w2=(m_s, d_fs))
    return out


def _block_specs(cfg: ModelConfig, kind: str, ax: MeshAxes) -> dict:
    """One layer's entries, keyed as ``BlockParams.named_parameters``."""
    mixer, ffn_kind = kind.split("+")
    out = {"norm1": (None,)}
    if ffn_kind != "none":
        out["norm2"] = (None,)
    if mixer == "attn":
        sub = ("attn", _mla_specs(cfg, ax) if cfg.is_mla
               else _gqa_specs(cfg, ax))
    else:
        sub = ("ssm", _ssm_specs(cfg, ax))
    out.update({f"{sub[0]}.{k}": v for k, v in sub[1].items()})
    if ffn_kind == "dense":
        d_fs, m_f = _dd(ax, cfg.d_model), _mm(ax, cfg.d_ff)
        out.update({"ffn.0": (d_fs, m_f), "ffn.1": (d_fs, m_f),
                    "ffn.2": (m_f, d_fs)})
    elif ffn_kind == "moe":
        out.update({f"moe.{k}": v for k, v in _moe_specs(cfg, ax).items()})
    return out


def param_layout(cfg: ModelConfig, ax: MeshAxes) -> dict:
    """Every parameter's entries, keyed by its name in
    ``LMParams.named_parameters()`` (the reference's ``lm_param_specs``
    with one entry per layer, as ``scan_layers=False`` builds them)."""
    emb = (_mm(ax, cfg.vocab_size), _dd(ax, cfg.d_model))
    out = {"embedding": emb}
    for i, kind in enumerate(layer_kinds(cfg)):
        out.update({f"layers.{i}.{k}": v
                    for k, v in _block_specs(cfg, kind, ax).items()})
    out["final_norm"] = (None,)
    if not cfg.tie_embeddings:
        out["lm_head"] = emb
    if cfg.frontend != "none":
        out["frontend_proj"] = (_dd(ax, cfg.d_model), _mm(ax, cfg.d_model))
    return out


def batch_specs(cfg: ModelConfig, ax: MeshAxes, kind: str,
                global_batch: int | None = None) -> dict:
    """The batch's entries (kind: train | prefill | decode): rows over the
    batch axes (replicated where ``global_batch`` does not divide over
    them), and for train and prefill the sequence over the model axis."""
    b = ax.batch if ax.sizes else None
    if b is not None and global_batch is not None and \
            not ax.div(global_batch, ax.batch):
        b = None
    seq = ax.model if (kind != "decode" and ax.sizes) else None
    spec = {"tokens": (b, seq)}
    if kind == "train":
        spec["targets"] = (b, seq)
    if cfg.frontend == "audio_frames":
        spec["frames"] = (b, seq, None)
        spec.pop("tokens")
    if cfg.frontend == "vision_patches" and kind != "decode":
        spec["patches"] = (b, None, None)
    return spec


def _cache_entry_spec(cfg: ModelConfig, kind: str, ax: MeshAxes,
                      batch: int):
    """One layer's decode cache entries (the reference's): an attention
    layer's positions over the model axis with every KV head (GQA) or the
    whole latent and rope key (MLA), the rows over the batch axes where
    ``batch`` divides; a Mamba layer's state over its heads and its conv
    tail over its channels (where they divide)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMState

    b = ax.batch if ax.sizes and ax.div(batch, ax.batch) else None
    m = ax.model if ax.sizes else None
    if kind.startswith("attn+"):
        tail = (None,) if cfg.is_mla else (None, None)
        return KVCache(k=(b, m) + tail, v=(b, m) + tail, length=(b,))
    s = cfg.ssm
    cc = s.d_inner + 2 * s.n_groups * s.d_state
    return SSMState(s=(b, _mm(ax, s.d_inner // s.headdim), None, None),
                    conv=(b, None, _mm(ax, cc)), length=(b,))


def cache_specs(cfg: ModelConfig, ax: MeshAxes, batch: int) -> list:
    """Every layer's decode cache entries (a :class:`KVCache` or
    :class:`SSMState` of entries, one a layer, as the reference's
    ``cache_specs`` with ``scan_layers=False``).  The port's caches take
    them, except a Mamba layer's state, which stays whole on every model
    rank while the mixer runs whole there (``transformer._ssm_view``)."""
    return [_cache_entry_spec(cfg, kind, ax, batch)
            for kind in layer_kinds(cfg)]


def opt_state_specs(layout: dict, optimizer: str) -> dict:
    """The optimizer state's entries by parameter name: AdamW's ``mu`` and
    ``nu`` mirror the parameters' (ZeRO falls out of FSDP); Adafactor's
    ``v_row`` drops the last entry and ``v_col`` the second last of a
    tensor of two or more dimensions (a vector keeps its ``v_row`` whole
    and a scalar ``v_col``)."""
    if optimizer == "adamw":
        return {"mu": dict(layout), "nu": dict(layout)}
    if optimizer == "adafactor":
        row = {n: s[:-1] if len(s) >= 2 else s for n, s in layout.items()}
        col = {n: s[:-2] + s[-1:] if len(s) >= 2 else ()
               for n, s in layout.items()}
        return {"v_row": row, "v_col": col}
    raise ValueError(f"unknown optimizer {optimizer!r}")


def activation_spec(ax: MeshAxes, kind: str) -> tuple:
    """The residual stream's entries, (B, S, D) rows x sequence."""
    if not ax.sizes:
        return ()
    return (ax.batch, ax.model if kind != "decode" else None, None)


def shard_shape(spec: tuple, global_shape, sizes: dict) -> tuple:
    """A rank's shard of a tensor of ``global_shape`` placed by ``spec``
    on a mesh of axis sizes ``sizes``."""
    ax = mesh_axes(sizes)
    return tuple(n // ax.size_of(e) for n, e in zip(global_shape, spec))


# ---------------------------------------------------------------- ranks ----

def on_model(entry) -> bool:
    """True where a placement entry is the model axis (or holds it)."""
    return entry is not None and (entry == "model" or (
        isinstance(entry, tuple) and "model" in entry))


def _dim_group(entry, pctx):
    """The group a dimension placed by ``entry`` is split over."""
    if entry is None:
        return None
    g = pctx.group if on_model(entry) else pctx.data
    return None if g is None or g.size == 1 else g


def dims_of(spec: tuple, pctx) -> tuple:
    """Per dimension, the group of ``pctx``'s mesh it is split over."""
    return tuple(_dim_group(e, pctx) for e in spec)


def _union(pctx, model: bool, data: bool):
    """The group of the model axis, the data axis or both (None: one
    rank)."""
    if model and data:
        return pctx.world_group
    g = pctx.group if model else pctx.data if data else None
    return None if g is None or g.size == 1 else g


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter lives on this rank's mesh.  ``spec``: its
    entries; ``dims``: per dimension, the group it is split over (None:
    whole); ``span``: the group whose ranks hold its distinct shards (the
    union of ``dims``); ``reduce``: the group whose sum of the ranks'
    gradients is the gradient (None: no sum); ``replicas``: the group of
    ranks holding the same values (None: this rank alone)."""

    spec: tuple
    dims: tuple
    span: object
    reduce: object
    replicas: object


def batch_rows(pctx, global_batch: int) -> slice:
    """This data rank's rows of a global batch of ``global_batch`` rows:
    its contiguous share, or every row where the batch does not divide
    over the data group (replicated, as the reference)."""
    D, d = pctx.data_size, pctx.data_rank
    if D == 1 or batch_replicated(pctx, global_batch):
        return slice(0, global_batch)
    b = global_batch // D
    return slice(d * b, (d + 1) * b)


def batch_replicated(pctx, global_batch: int) -> bool:
    """True where every data row holds the whole global batch (it does
    not divide over the data group)."""
    return pctx.data_size > 1 and global_batch % pctx.data_size != 0


def stream_whole(pctx, seq: int) -> bool:
    """True where a sequence of ``seq`` does not divide by the model axis:
    the residual stream then stays whole on every model rank (the
    reference's ``wsc``)."""
    return pctx.ep_size > 1 and seq % pctx.ep_size != 0


def local_batch(batch: dict, pctx, kind: str = "train") -> dict:
    """``batch`` (every value (B, ...)) cut to this rank's share
    (:func:`batch_specs`): its data rank's rows, and for train and prefill
    its model rank's shard of the sequence (axis 1) of every value but a
    vision stub's patches, where the sequence divides by the model axis
    (else it stays whole: :func:`stream_whole`)."""
    B = next(iter(batch.values())).shape[0]
    rows = batch_rows(pctx, B)
    out = {k: v[rows] for k, v in batch.items()}
    T = pctx.ep_size
    if T > 1 and kind != "decode":
        for k, v in out.items():
            if k == "patches" or stream_whole(pctx, v.shape[1]):
                continue
            n = v.shape[1] // T
            out[k] = v[:, pctx.ep_rank * n:(pctx.ep_rank + 1) * n]
    return out


def lm_param_specs(params, pctx) -> list[Placement]:
    """One :class:`Placement` per tensor of ``params.parameters()``, in
    that order, from the layout it was built with (``LMParams.layout``;
    see the module's notes; on one rank every tensor is whole)."""
    lay = params.layout
    out = []
    for name, p in params.named_parameters():
        spec = (None,) * p.dim() if lay is None else lay[name]
        dims = dims_of(spec, pctx)
        by_model = any(on_model(e) for e in spec)
        by_data = any(e is not None and not on_model(e) for e in spec)
        span = _union(pctx, by_model and pctx.group is not None,
                      by_data and pctx.data is not None)
        reduce = replicas = _union(pctx, not by_model, not by_data)
        out.append(Placement(spec, dims, span, reduce, replicas))
    return out


def cut(t: torch.Tensor, dims: tuple) -> torch.Tensor:
    """This rank's shard of a whole ``t`` (a view): along each dimension
    its slice over the dimension's group (None: whole)."""
    for d, g in enumerate(dims):
        if g is None:
            continue
        if t.shape[d] % g.size:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {g.size} ranks")
        n = t.shape[d] // g.size
        t = t.narrow(d, g.rank * n, n)
    return t


def gather_whole(t: torch.Tensor, dims: tuple) -> torch.Tensor:
    """The whole tensor from every rank's shard ``t`` (collective over each
    dimension's group; no gradient)."""
    from repro_torch.parallel import collectives

    for d, g in enumerate(dims):
        if g is not None:
            t = collectives.gather_along(g, t.detach(), d)
    return t


def shard_params_(module, layout: dict, pctx, prefix: str = "") -> None:
    """Cut every parameter of ``module`` (named ``prefix`` + its name in
    ``layout``) to this rank's shard, in place; a MoE block's expert
    weights are rebuilt in slot buffers of their shard's shape."""
    from repro_torch.moe.layer import MoEParams

    for name, sub in list(module.named_children()):
        if isinstance(sub, MoEParams):
            key = f"{prefix}{name}."
            w = {}
            for n in ("router", "w1", "w3", "w2", "shared_w1", "shared_w3",
                      "shared_w2"):
                t = getattr(sub, n)
                if t is None:
                    w[n] = None
                    continue
                dims = list(dims_of(layout[key + n], pctx))
                if n in ("w1", "w3", "w2"):
                    dims[0] = None        # the EP rank's experts already
                w[n] = cut(t.data, tuple(dims)).clone()
            setattr(module, name, MoEParams(**w, n_slot=sub.n_slot))
        else:
            shard_params_(sub, layout, pctx, f"{prefix}{name}.")
    for name, p in list(module.named_parameters(recurse=False)):
        dims = dims_of(layout[prefix + name], pctx)
        if any(g is not None for g in dims):
            p.data = cut(p.data, dims).clone()


def use(t: torch.Tensor, spec: tuple, pctx, *, model: bool = False,
        out: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor a rank computes with from its shard ``t`` placed by
    ``spec``: gathered over the batch axes (FSDP) and, with ``model``,
    over the model axis too (a weight whose model split is not a head
    split); under a gradient each gather's backward reduce-scatters.
    ``out``: where to put the result of a gather along one dimension (a
    slot buffer's head)."""
    from repro_torch.parallel import collectives

    steps = [(d, pctx.group if on_model(e) else pctx.data)
             for d, e in enumerate(spec)
             if e is not None and (model or not on_model(e))]
    steps = [(d, g) for d, g in steps if g is not None and g.size > 1]
    for i, (d, g) in enumerate(steps):
        last = i == len(steps) - 1
        t = collectives.gather_along(g, t, d, out=out if last else None)
    return t


def block_layout(cfg: ModelConfig, kind: str, pctx) -> dict:
    """One layer's entries on ``pctx``'s mesh, keyed as
    ``BlockParams.named_parameters``."""
    return _block_specs(cfg, kind, from_ctx(pctx))


def lm_layout(cfg: ModelConfig, pctx) -> dict:
    """:func:`param_layout` on ``pctx``'s mesh."""
    return param_layout(cfg, from_ctx(pctx))

"""RSN-native balancing-communication planning (paper S6).

Mirrors ``repro.core.comm_plan`` (host-side numpy):

1. **Schedule construction** (``build_relay_schedule``): the paper's
   load-aware relay algorithm (S6.2) -- relay frontier ~ sqrt(F), relays
   picked from the expert's replica ranks with the smallest current send
   volume, leaves attached to keep projected volumes minimal; with a
   two-level topology, one inter-rack copy per remote rack, fanned out
   inside the rack.

2. **alpha-beta simulation** (``simulate``): an event-driven chunk-level
   model of per-rank send/receive channels (near-constant latency under
   relay vs linear fan-out growth without, Fig. 16).

The data plane it models is the replica stream of
:mod:`repro_torch.moe.distribute` (a reduce-scatter, tiered on a factored
group); :meth:`repro_torch.moe.stages.Resilience.relay_schedule` builds
the schedule of a solved plan under the live rank speeds.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from repro_torch.core.quantize import payload_bytes_per_item
from repro_torch.core.topology import Topology

__all__ = ["Edge", "RelaySchedule", "SimStats", "build_relay_schedule",
           "simulate", "tier_wire_bytes"]


def tier_wire_bytes(tier_tokens, d_model: int, wire_dtype: str = "none",
                    base_bytes: int = 4) -> np.ndarray:
    """(3,) one-way dispatch-wire bytes per tier ``[local, intra, inter]``.

    The host-side mirror of the ``MoEStats.tier_bytes`` accounting: the
    planner's per-tier token volumes times the per-item payload width of
    ``wire_dtype`` (``repro_torch.core.quantize`` -- int8 adds 4 in-band
    scale bytes per token row), so the cost model and the device stats
    cannot drift on what a wire byte is.
    """
    t = np.asarray(tier_tokens, dtype=np.int64)
    return t * int(payload_bytes_per_item(d_model, wire_dtype, base_bytes))


@dataclasses.dataclass(frozen=True)
class Edge:
    """One expert-state transfer edge."""

    src: int
    dst: int
    expert: int
    nbytes: int
    stage: int          # 0 = direct/stage-one, 1 = relay stage-two
    depends_on: int = -1  # index of the stage-one edge this leaf waits on


@dataclasses.dataclass
class RelaySchedule:
    edges: list[Edge]
    send_volume: np.ndarray  # (R,) planned bytes leaving each rank

    @property
    def max_send_volume(self) -> int:
        return int(self.send_volume.max()) if self.send_volume.size else 0


def _speed_vec(rank_speed, R: int) -> np.ndarray | None:
    """Validate and clamp a per-rank channel speed vector (None passthrough).

    Speeds are relative factors in (0, 1]; a degraded rank's channel takes
    1/speed times longer per chunk.  Zero speeds are clamped to 1e-3 -- a
    fully dead rank should not appear in schedules at all (the
    health-weighted planner drains it), but the simulator must stay finite
    if one does.
    """
    if rank_speed is None:
        return None
    s = np.asarray(rank_speed, dtype=np.float64).reshape(-1)
    if s.shape[0] != R:
        raise ValueError(f"rank_speed has {s.shape[0]} entries, expected {R}")
    if (s < 0).any() or not np.isfinite(s).all():
        raise ValueError("rank_speed entries must be finite and >= 0")
    return np.clip(s, 1e-3, None)


def build_relay_schedule(
    hosted: np.ndarray,
    home: np.ndarray,
    expert_bytes: int,
    *,
    relay_threshold: int = 3,
    num_ranks: int | None = None,
    topology: Topology | None = None,
    rank_speed=None,
) -> RelaySchedule:
    """Load-aware relay-tree construction (paper S6.2).

    Args:
      hosted: (E, R) bool physical-instance indicator (mains + replicas).
      home: (E,) home rank per expert.
      expert_bytes: weight (or gradient) bytes of one expert.
      relay_threshold: fan-outs strictly above this get a two-stage relay.
      topology: optional two-level fabric.  When given, it emits a
        **rack-relay tree**: each remote rack hosting replicas receives
        exactly ONE inter-rack copy (minimal scale-out volume), landed on
        its least-loaded replica host; that rack-relay then fans out to its
        rack-mates over the scale-up fabric, so leaf fan-out is intra-rack
        *by construction*.  Inter-rack copies are themselves spread
        load-aware across the home and already-fed rack-relays (a broadcast
        tree over racks), so no single sender serialises the scale-out hop;
        chunk pipelining in :func:`simulate` hides the added tree depth.
      rank_speed: optional (R,) per-rank channel speed factors in (0, 1]
        (see :class:`repro_torch.core.health.RankHealth`): a 0.5x rank's channel
        time doubles, so the load-aware trackers route relay duty *around*
        degraded ranks instead of onto them.  ``None`` = all full speed.

    Returns a :class:`RelaySchedule` with per-chunk dependencies encoded at
    edge granularity (chunk pipelining is applied by :func:`simulate`).
    """
    hosted = np.asarray(hosted, dtype=bool)
    home = np.asarray(home, dtype=np.int64)
    E, R = hosted.shape
    R = num_ranks or R
    speed = _speed_vec(rank_speed, R)

    send_volume = np.zeros(R, dtype=np.int64)
    edges: list[Edge] = []

    if topology is not None and topology.racks > 1:
        if topology.ep_size != R:
            raise ValueError(
                f"topology {topology.racks}x{topology.ranks_per_rack} "
                f"does not cover R={R} ranks")
        # Channel-cost trackers in *seconds* (tier-aware): an inter-rack
        # send occupies the channel beta_intra/beta_inter times longer than
        # an intra-rack one, so pricing decisions in bytes would overload
        # the scale-out senders.  ``send_volume`` stays bytes for reporting.
        send_cost = np.zeros(R)
        recv_cost = np.zeros(R)

        def edge_secs(a: int, b: int) -> float:
            al, beta = topology.link(a, b)
            secs = al + expert_bytes / beta
            if speed is not None:
                # The slowest endpoint gates the transfer.
                secs /= min(speed[a], speed[b])
            return secs

        def add_edge(f_rank: int, t: int, e: int, stage: int,
                     dep: int) -> int:
            idx = len(edges)
            edges.append(Edge(int(f_rank), int(t), e, expert_bytes, stage,
                              dep))
            secs = edge_secs(f_rank, t)
            send_cost[f_rank] += secs
            recv_cost[t] += secs
            send_volume[f_rank] += expert_bytes
            return idx

        # Hot experts first so their relays grab the least-loaded hosts.
        fanouts = [(e, np.where(hosted[e])[0]) for e in range(E)]
        fanouts = [(e, d[d != home[e]]) for e, d in fanouts]
        fanouts.sort(key=lambda it: (-len(it[1]), it[0]))
        for e, dsts in fanouts:
            if len(dsts) == 0:
                continue
            src = int(home[e])
            home_rack = topology.rack_of(src)
            by_rack: dict[int, list[int]] = {}
            for t in dsts.tolist():
                by_rack.setdefault(topology.rack_of(t), []).append(t)

            def grow_tree(members, feeders, stage0_root):
                """Feed ``members`` one by one, each by the cheapest-channel
                rank already holding the expert; receivers become feeders (a
                load-aware broadcast tree; chunk pipelining amortises its
                depth)."""
                for t in sorted(members, key=lambda t: (send_cost[t], t)):
                    f_rank, f_edge = min(
                        feeders, key=lambda fr: (send_cost[fr[0]], fr[0]))
                    idx = add_edge(f_rank, t, e,
                                   0 if (stage0_root and f_edge < 0) else 1,
                                   f_edge)
                    feeders.append((int(t), idx))

            # Home-rack replicas: a scale-up tree rooted at the home.
            grow_tree(by_rack.pop(home_rack, []), [(src, -1)], True)
            # Remote racks (largest first): exactly one inter-rack copy each
            # (minimal scale-out volume), landed on the member with the
            # least-loaded receive channel and fed by the cheapest holder
            # anywhere (home or an already-fed rack relay); the rack then
            # fans out intra-rack.
            rack_feeders: list[tuple[int, int]] = [(src, -1)]
            for g in sorted(by_rack, key=lambda g: (-len(by_rack[g]), g)):
                members = by_rack[g]
                relay = min(members, key=lambda t: (recv_cost[t],
                                                    send_cost[t], t))
                f_rank, f_edge = min(
                    rack_feeders, key=lambda fr: (send_cost[fr[0]], fr[0]))
                relay_idx = add_edge(f_rank, relay, e,
                                     0 if f_edge < 0 else 1, f_edge)
                rack_feeders.append((int(relay), relay_idx))
                grow_tree([t for t in members if t != relay],
                          [(int(relay), relay_idx)], False)
        return RelaySchedule(edges=edges, send_volume=send_volume)

    # Pass 1: direct sends for small fan-outs seed the volume tracker.
    replica_sets: list[tuple[int, np.ndarray]] = []
    for e in range(E):
        dsts = np.where(hosted[e])[0]
        dsts = dsts[dsts != home[e]]
        if len(dsts) == 0:
            continue
        if len(dsts) <= relay_threshold:
            for t in dsts:
                edges.append(Edge(int(home[e]), int(t), e, expert_bytes, 0))
            send_volume[home[e]] += expert_bytes * len(dsts)
        else:
            replica_sets.append((e, dsts))

    # Pass 2: relay-eligible hot experts, descending fan-out.
    replica_sets.sort(key=lambda it: (-len(it[1]), it[0]))
    # Effective relay cost: planned bytes scaled by the rank's channel
    # slowdown, so a half-speed rank looks twice as loaded and relay duty
    # routes around it.
    _eff = ((lambda r, v: v / speed[r]) if speed is not None
            else (lambda r, v: v))
    for e, dsts in replica_sets:
        fanout = len(dsts)
        n_relay = max(1, min(fanout, round(math.sqrt(fanout))))
        # Relays: replica ranks with the smallest current send volume.
        order = sorted(dsts.tolist(),
                       key=lambda t: (_eff(t, send_volume[t]), t))
        relays = order[:n_relay]
        leaves = order[n_relay:]

        src = int(home[e])
        relay_edge_idx = {}
        for t in relays:
            relay_edge_idx[t] = len(edges)
            edges.append(Edge(src, int(t), e, expert_bytes, 0))
        send_volume[src] += expert_bytes * n_relay

        # Leaves attach to the relay whose projected volume stays smallest.
        proj = {t: send_volume[t] for t in relays}
        for leaf in leaves:
            t = min(relays, key=lambda x: (_eff(x, proj[x]), x))
            edges.append(
                Edge(int(t), int(leaf), e, expert_bytes, 1, relay_edge_idx[t])
            )
            proj[t] += expert_bytes
        for t in relays:
            send_volume[t] = proj[t]

    return RelaySchedule(edges=edges, send_volume=send_volume)


@dataclasses.dataclass(frozen=True)
class SimStats:
    """Per-edge completion statistics of one simulated schedule."""

    edge_finish: np.ndarray       # (n_edges,) arrival time of each edge's
                                  #   last chunk (seconds)
    edge_is_inter: np.ndarray     # (n_edges,) bool, True = crossed racks
    intra_bytes: int              # bytes moved on the scale-up fabric
    inter_bytes: int              # bytes moved on the scale-out fabric

    @property
    def last_intra(self) -> float:
        t = self.edge_finish[~self.edge_is_inter]
        return float(t.max()) if t.size else 0.0

    @property
    def last_inter(self) -> float:
        t = self.edge_finish[self.edge_is_inter]
        return float(t.max()) if t.size else 0.0


def simulate(
    schedule: RelaySchedule,
    *,
    num_ranks: int,
    link_bandwidth: float,
    alpha: float = 2e-6,
    chunk_bytes: int = 1 << 20,
    topology: Topology | None = None,
    rank_speed=None,
    return_stats: bool = False,
) -> float | tuple[float, SimStats]:
    """Event-driven chunk-level alpha-beta simulation of the schedule.

    Each rank has one send channel and one receive channel; a chunk occupies
    its channel for ``alpha + chunk/beta`` seconds.  A stage-two (leaf) chunk
    may start only after the *same chunk index* arrived at the relay (the
    paper's per-chunk ready flag, Fig. 10).

    With ``topology``, each edge uses its tier's link model (intra-rack edges
    ``intra_alpha/intra_beta``, inter-rack edges ``inter_alpha/inter_beta``)
    and the flat ``alpha``/``link_bandwidth`` arguments are ignored.

    ``rank_speed`` ((R,) factors in (0, 1], None = full speed) stretches a
    chunk's channel occupancy by ``1 / min(speed[src], speed[dst])``: the
    degraded-fabric counterpart of the scheduler's speed-aware trackers, so
    the same vector prices both planning and simulation.

    Returns the makespan in seconds; with ``return_stats=True``, returns
    ``(makespan, SimStats)`` with the per-edge completion times (a Fig.
    16-style trajectory).
    """
    send_free = np.zeros(num_ranks)
    recv_free = np.zeros(num_ranks)
    speed = _speed_vec(rank_speed, num_ranks)

    def link(e: Edge) -> tuple[float, float]:
        if topology is None:
            return alpha, link_bandwidth
        return topology.link(e.src, e.dst)

    n_edges = len(schedule.edges)
    n_chunks = {
        i: max(1, -(-e.nbytes // chunk_bytes)) for i, e in enumerate(schedule.edges)
    }
    edge_finish = np.zeros(n_edges)
    edge_is_inter = np.array(
        [topology is not None and not topology.same_rack(e.src, e.dst)
         for e in schedule.edges], dtype=bool,
    ) if n_edges else np.zeros(0, dtype=bool)

    # Priority queue of (ready_time, order, edge_idx, chunk_idx).
    pq: list[tuple[float, int, int, int]] = []
    order = 0
    for i, e in enumerate(schedule.edges):
        if e.stage == 0:
            for c in range(n_chunks[i]):
                heapq.heappush(pq, (0.0, order, i, c))
                order += 1

    pending_leaves: dict[int, list[int]] = {}
    for i, e in enumerate(schedule.edges):
        if e.stage == 1:
            pending_leaves.setdefault(e.depends_on, []).append(i)

    makespan = 0.0
    while pq:
        ready, _, i, c = heapq.heappop(pq)
        e = schedule.edges[i]
        a, beta = link(e)
        this_bytes = min(chunk_bytes, e.nbytes - c * chunk_bytes)
        start = max(ready, send_free[e.src], recv_free[e.dst])
        secs = a + this_bytes / beta
        if speed is not None:
            secs /= min(speed[e.src], speed[e.dst])
        finish = start + secs
        send_free[e.src] = finish
        recv_free[e.dst] = finish
        edge_finish[i] = max(edge_finish[i], finish)
        makespan = max(makespan, finish)
        # Wake dependent stage-two chunks of the same chunk index.
        for leaf_idx in pending_leaves.get(i, ()):  # leaf shares chunking
            heapq.heappush(pq, (finish, order, leaf_idx, c))
            order += 1
    if not return_stats:
        return makespan
    nbytes = np.array([e.nbytes for e in schedule.edges], dtype=np.int64)
    stats = SimStats(
        edge_finish=edge_finish,
        edge_is_inter=edge_is_inter,
        intra_bytes=int(nbytes[~edge_is_inter].sum()) if n_edges else 0,
        inter_bytes=int(nbytes[edge_is_inter].sum()) if n_edges else 0,
    )
    return makespan, stats

"""Two-level EP fabric topology (the paper's multi-RSN deployment, S3/S7).

Mirrors ``repro.core.topology``.  A rack-scale node (RSN) is a scale-up
domain: every rank inside a rack sees every other rank over the fat
intra-rack fabric (NVLink class).  Racks are joined by a thinner scale-out
fabric (RDMA class).  The EP group of ``R = racks * ranks_per_rack`` ranks
is therefore two-level: rank ``r`` factors as ``(rack, lane) = (r // L, r %
L)`` with ``L = ranks_per_rack``.  The order is rack-major, so a factored
group and a flat group number their ranks alike, and a one-rack topology is
the flat EP group.

The planner takes plain ``ranks_per_rack`` ints; the alpha-beta link model
is kept as data for callers that model the wire.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Topology"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """racks x ranks_per_rack EP fabric with a per-tier alpha-beta link model.

    ``*_alpha`` is the per-message latency (seconds), ``*_beta`` the link
    bandwidth (bytes/second).  The defaults model a 100 GB/s scale-up domain
    and a 4x thinner scale-out fabric with ~10x the message latency.
    """

    racks: int = 1
    ranks_per_rack: int = 1
    intra_alpha: float = 2e-6
    intra_beta: float = 100e9
    inter_alpha: float = 20e-6
    inter_beta: float = 25e9

    def __post_init__(self):
        if self.racks < 1 or self.ranks_per_rack < 1:
            raise ValueError(
                f"topology {self.racks}x{self.ranks_per_rack} must be >= 1x1")

    @classmethod
    def flat(cls, ep_size: int, **kw) -> "Topology":
        """Single-rack (flat) topology over ``ep_size`` ranks."""
        return cls(racks=1, ranks_per_rack=ep_size, **kw)

    @property
    def ep_size(self) -> int:
        return self.racks * self.ranks_per_rack

    def rack_of(self, rank: int) -> int:
        return int(rank) // self.ranks_per_rack

    def lane_of(self, rank: int) -> int:
        return int(rank) % self.ranks_per_rack

    def same_rack(self, a: int, b: int) -> bool:
        return self.rack_of(a) == self.rack_of(b)

    def link(self, src: int, dst: int) -> tuple[float, float]:
        """(alpha, beta) of the src->dst link by tier."""
        if self.same_rack(src, dst):
            return self.intra_alpha, self.intra_beta
        return self.inter_alpha, self.inter_beta

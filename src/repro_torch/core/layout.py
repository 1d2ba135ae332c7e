"""Expert layout: logical <-> physical slot mapping (paper S4.1).

Mirrors ``repro.core.layout``.  Every rank owns ``E/R`` main slots (home
placement in contiguous blocks, ``h(e) = e // (E/R)``) plus ``n_slot``
redundant slots that a solved plan binds to logical experts.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ExpertLayout", "physical_slot_of"]

_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class ExpertLayout:
    """Static layout metadata for one EP group."""

    num_experts: int          # E, logical experts
    ep_size: int              # R, ranks in the EP group
    n_slot: int               # redundant slots per rank

    def __post_init__(self):
        if self.num_experts % self.ep_size != 0:
            raise ValueError(
                f"num_experts={self.num_experts} must divide by ep={self.ep_size}")

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.ep_size

    @property
    def slots_per_rank(self) -> int:
        """Main + redundant physical slots per rank."""
        return self.experts_per_rank + self.n_slot

    def home(self, device="cuda") -> torch.Tensor:
        """(E,) home rank of each logical expert (contiguous blocks)."""
        return torch.div(torch.arange(self.num_experts, dtype=_I64,
                                      device=device),
                         self.experts_per_rank, rounding_mode="floor")


def physical_slot_of(layout: ExpertLayout, x: torch.Tensor) -> torch.Tensor:
    """(R, E) physical slot of expert e on rank r, -1 if not hosted.

    Mirrors ``repro.core.layout.physical_slot_of``: mains map to their static
    slot, replicas to ``E/R + s`` for the redundant slot ``s`` that ``x``
    binds.  The JAX version scans the slots with ``lax.scan``; here each slot
    is one scatter into a spare column E that swallows empty (-1) entries,
    and a later slot overwrites an earlier one exactly as the scan does.
    """
    R, E = layout.ep_size, layout.num_experts
    epr = layout.experts_per_rank
    dev = x.device
    experts = torch.arange(E, dtype=_I64, device=dev)
    home = experts // epr
    ranks = torch.arange(R, dtype=_I64, device=dev)
    main_slot = torch.where(home[None, :] == ranks[:, None],
                            (experts % epr)[None, :],
                            torch.full((), -1, dtype=_I64, device=dev))
    red = torch.full((R, E + 1), -1, dtype=_I64, device=dev)
    x = x.to(_I64)
    for s in range(layout.n_slot):
        col = torch.where(x[:, s] >= 0, x[:, s], E)
        red.scatter_(1, col[:, None],
                     torch.full((R, 1), epr + s, dtype=_I64, device=dev))
    red = red[:, :E]
    return torch.where(red >= 0, red, main_slot)

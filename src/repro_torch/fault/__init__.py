"""Deterministic fault injection for degraded-fabric testing (DESIGN.md S13;
mirrors ``repro.fault``)."""

from repro_torch.fault.injector import (
    FAULT_KINDS,
    FaultInjector,
    FaultSpec,
    PlannerFault,
    SolveTimeout,
    TransferFault,
)

__all__ = [
    "FAULT_KINDS",
    "FaultInjector",
    "FaultSpec",
    "PlannerFault",
    "SolveTimeout",
    "TransferFault",
]

"""repro_torch.fleet — simulated fleet of FHE serving devices.

Generalizes the single `PipelinedExecutor` to N devices, each wrapping
any `resolve_backend` backend with its own key/compile cache and
discrete-event clock, under one admission-time `Router` and an
SLO-aware `FleetScheduler` (deadline priority, round-boundary
preemption, continuous slot batching). See DESIGN.md §11.
"""
from repro_torch.fleet.device import Device, Flight
from repro_torch.fleet.router import POLICIES, Router
from repro_torch.fleet.scheduler import FleetScheduler, build_fleet

__all__ = ["Device", "Flight", "Router", "POLICIES",
           "FleetScheduler", "build_fleet"]

"""Workload generators of the port (port of ``repro/workloads``)."""
from repro_torch.workloads.base import FAR, Prefill, Workload, as_workload
from repro_torch.workloads.generators import (
    ClosedLoop,
    MixedReadWrite,
    MultiTenant,
    PoissonOpenLoop,
    SteadyStateMixed,
    TraceReplay,
    ZipfClosedLoop,
)

__all__ = [
    "FAR",
    "Prefill",
    "Workload",
    "as_workload",
    "ClosedLoop",
    "MixedReadWrite",
    "MultiTenant",
    "PoissonOpenLoop",
    "SteadyStateMixed",
    "TraceReplay",
    "ZipfClosedLoop",
]

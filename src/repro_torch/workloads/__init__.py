"""Workload generators of the port (port of ``repro/workloads``)."""
from repro_torch.workloads.base import Prefill, Workload, as_workload
from repro_torch.workloads.generators import ClosedLoop, MixedReadWrite

__all__ = [
    "Prefill",
    "Workload",
    "as_workload",
    "ClosedLoop",
    "MixedReadWrite",
]

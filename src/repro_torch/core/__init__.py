"""Core of the port: the plan API, the device seeders and the host prepare
(tree embedding, LSH keys, quantisation, sample structures)."""

from repro_torch.core.batch_schedule import BatchSchedule, shape_bucket
from repro_torch.core.plan import (
    ClusterPlan,
    ClusterSpec,
    ExecutionSpec,
    FitResult,
    PreparedData,
)

__all__ = [
    "BatchSchedule",
    "shape_bucket",
    "ClusterPlan",
    "ClusterSpec",
    "ExecutionSpec",
    "FitResult",
    "PreparedData",
]

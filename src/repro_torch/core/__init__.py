"""Core of the port: the plan API and the legacy facade, the seeder
registry with its two backends (the seeders on the card and the faithful
NumPy seeders on the host), the pipelined, fault-tolerant engine and its
resilience primitives, streaming (mutable prepared streams, drift
detection, mini-batch refinement, dynamic k), and the host structures
(tree embedding, LSH, multi-tree sampler, quantisation, sample
structures).

Exports every name of the JAX package's `repro.core.__all__`.
"""

from repro_torch.core.api import (
    BACKENDS,
    ClusterPlan,
    ClusterSpec,
    ExecutionSpec,
    FitResult,
    KMeans,
    KMeansConfig,
    PreparedData,
    SEEDER_SPECS,
    SeederSpec,
    capability_table,
    data_fingerprint,
    ensure_host_f64,
    fit,
    resolve_seeder,
)
from repro_torch.core.batch_schedule import BatchSchedule, shape_bucket
from repro_torch.core.engine import ClusterEngine, FitTicket
from repro_torch.core.lloyd import assign, lloyd
from repro_torch.core.multitree import MultiTreeSampler
from repro_torch.core.resilience import (
    CircuitBreaker,
    CircuitBreakerPolicy,
    DeadlineExceededError,
    FaultPlan,
    InjectedFault,
    InvalidInputError,
    QueueFullError,
    RemoteError,
    RetryPolicy,
    ServiceUnavailableError,
    attempt_seed,
    classify_failure,
    exception_from_wire,
    exception_to_wire,
    fallback_chain,
    register_wire_error,
    validate_points,
)
from repro_torch.core.seeding import (
    SEEDERS,
    SeedingResult,
    afkmc2,
    clustering_cost,
    fast_kmeanspp,
    kmeans_parallel,
    kmeanspp,
    rejection_sampling,
    uniform_sampling,
)
from repro_torch.core.streaming import (
    DriftDetector,
    DriftPolicy,
    MiniBatchRefiner,
    StreamingController,
    StreamingOps,
    StreamState,
    split_merge_k,
)
from repro_torch.core.tracing import RetraceError, TRACE_COUNTS, no_retrace
from repro_torch.core.tree_embedding import MultiTreeEmbedding, build_multitree

__all__ = [
    "BACKENDS",
    "BatchSchedule",
    "CircuitBreaker",
    "CircuitBreakerPolicy",
    "ClusterEngine",
    "ClusterPlan",
    "ClusterSpec",
    "DeadlineExceededError",
    "ExecutionSpec",
    "FaultPlan",
    "FitResult",
    "FitTicket",
    "InjectedFault",
    "InvalidInputError",
    "KMeans",
    "KMeansConfig",
    "PreparedData",
    "QueueFullError",
    "RemoteError",
    "RetryPolicy",
    "ServiceUnavailableError",
    "shape_bucket",
    "exception_from_wire",
    "exception_to_wire",
    "register_wire_error",
    "SEEDER_SPECS",
    "SeederSpec",
    "RetraceError",
    "TRACE_COUNTS",
    "no_retrace",
    "attempt_seed",
    "capability_table",
    "classify_failure",
    "fallback_chain",
    "validate_points",
    "data_fingerprint",
    "ensure_host_f64",
    "fit",
    "resolve_seeder",
    "assign",
    "lloyd",
    "kmeans_parallel",
    "MultiTreeSampler",
    "SEEDERS",
    "SeedingResult",
    "afkmc2",
    "clustering_cost",
    "fast_kmeanspp",
    "kmeanspp",
    "rejection_sampling",
    "uniform_sampling",
    "MultiTreeEmbedding",
    "build_multitree",
    "StreamingOps",
    "StreamState",
    "DriftPolicy",
    "DriftDetector",
    "MiniBatchRefiner",
    "StreamingController",
    "split_merge_k",
]

"""Wire transport over `ClusterFrontend`: binary RPC, tenancy, SLO stats
(the JAX package's `serving/net`, the same frames byte for byte).

The serving stack so far ends at
`repro_torch.serving.frontend.ClusterFrontend` — in-process continuous
batching.  This package puts it on a socket with
nothing but the stdlib: `protocol` is the versioned length-prefixed
frame codec (raw f32/f64 point/center buffers, typed wire errors),
`server` the multi-client RPC server (per-connection reader threads,
out-of-order streaming delivery, chunked uploads), `client` the blocking
client (reconnect-and-resend retries made safe by deterministic
serving), and `tenancy` the multi-tenant admission layer (token-bucket
quotas, weighted-fair dispatch).  The loopback result is bit-identical
to an in-process `frontend.submit` — the wire adds delivery, not drift.
Frame format and operations guide: docs/net.md.
"""

from repro_torch.serving.net.client import ClusterClient
from repro_torch.serving.net.protocol import (
    FrameReader,
    MAX_FRAME_BYTES,
    PROTOCOL_VERSION,
    ProtocolError,
    decode_frame,
)
from repro_torch.serving.net.server import ClusterServer
from repro_torch.serving.net.tenancy import (
    QuotaExceededError,
    TenantPolicy,
    TenantScheduler,
    parse_tenants,
)

__all__ = [
    "ClusterClient",
    "ClusterServer",
    "FrameReader",
    "MAX_FRAME_BYTES",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "QuotaExceededError",
    "TenantPolicy",
    "TenantScheduler",
    "decode_frame",
    "parse_tenants",
]

"""Versioned length-prefixed binary frame codec for the cluster RPC wire:
the JAX package's `serving/net/protocol.py`, byte for byte.

Everything `repro_torch.serving.net` puts on a socket is a **frame**:

    +----------------+---------+---------+------------------+----------+
    | u32 length     | u8 ver  | u8 type | u64 request_id   | body ... |
    +----------------+---------+---------+------------------+----------+
      of the rest      =1        SUBMIT/RESULT/...            per type

All integers are little-endian (``struct`` ``"<"``); point/center
payloads are raw C-order f32/f64 buffers — a `SubmitFrame` round-trips a
numpy array bit-for-bit, which is what lets the server hand the *exact*
submitted dataset to `ClusterFrontend.submit` and the loopback result
stay bit-identical to an in-process fit (the contract asserted in
tests/test_torch_net.py).  Structured metadata that is not on the latency
path (result extras, STATS payloads) rides as UTF-8 JSON.

Frame types:

* ``SUBMIT`` — dtype+shape header (n, d, f32/f64), optional k/seed
  overrides, deadline seconds, priority, tenant, and — unless the
  ``streamed`` flag is set — the raw point buffer inline.
* ``EXTEND`` — one streaming append-then-refit against a named
  server-side stream (`docs/streaming.md`): the stream label plus the
  same dtype+shape header and point buffer as ``SUBMIT`` (chunked
  uploads reuse ``STREAM_CHUNK``).  The first ``EXTEND`` for a label
  creates the stream from its batch; an ``n == 0`` frame refits the
  stream without mutating it (the remote drift-reseed nudge).
* ``STREAM_CHUNK`` — one fragment of a streamed point upload (large
  datasets cross the wire in bounded chunks instead of one giant frame);
  the fragment flagged ``last`` completes the upload.
* ``RESULT`` — chosen indices (i64), centers (raw f32/f64), cost (f64)
  and a JSON extras blob carrying the SLO attribution
  (queue_wait / solve / network breakdown).
* ``STATS`` — empty-body request; JSON-body response with the server's
  `stats()` (frontend ledger + per-tenant counters + breakdown).
* ``ERROR`` — typed failure: a `repro_torch.core.resilience` wire code plus
  message, reconstructed client-side by `exception_from_wire` so remote
  failures raise exactly like local ones.

Malformed input raises `ProtocolError` (wire code
``WIRE_PROTOCOL_ERROR``): bad magic version, unknown frame type,
truncated body, or a length prefix above `MAX_FRAME_BYTES` (a corrupted
prefix must not make the reader allocate gigabytes).  `FrameReader` is
the incremental decoder: feed it ``recv()`` bytes, it yields complete
frames and buffers the rest.  Wire format table: docs/net.md.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import exception_to_wire, register_wire_error
from repro_torch.core.resilience import WIRE_PROTOCOL_ERROR

__all__ = [
    "FRAME_ERROR",
    "FRAME_EXTEND",
    "FRAME_RESULT",
    "FRAME_STATS",
    "FRAME_STREAM_CHUNK",
    "FRAME_SUBMIT",
    "ChunkFrame",
    "ErrorFrame",
    "ExtendFrame",
    "FrameReader",
    "MAX_FRAME_BYTES",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "ResultFrame",
    "StatsFrame",
    "SubmitFrame",
    "decode_frame",
    "jsonable",
]

#: Bump on any incompatible layout change; decoders reject mismatches.
PROTOCOL_VERSION = 1

#: Upper bound on one frame's payload: a corrupted length prefix fails
#: typed instead of OOM-ing the reader.  Streamed uploads keep individual
#: frames far below this regardless of dataset size.
MAX_FRAME_BYTES = 256 * 1024 * 1024

FRAME_SUBMIT = 1
FRAME_RESULT = 2
FRAME_STREAM_CHUNK = 3
FRAME_STATS = 4
FRAME_ERROR = 5
FRAME_EXTEND = 6

_HEADER = struct.Struct("<BBQ")          # version, frame type, request id
_LENGTH = struct.Struct("<I")

_DTYPE_CODES = {"f32": 0, "f64": 1}
_DTYPE_NAMES = {0: "f32", 1: "f64"}
_NP_DTYPES = {"f32": np.dtype("<f4"), "f64": np.dtype("<f8")}

_SUBMIT_FLAG_STREAMED = 1
_CHUNK_FLAG_LAST = 1


class ProtocolError(RuntimeError):
    """The byte stream violates the frame contract (malformed/unsupported).

    Raised by the decoders; the server answers with an ``ERROR`` frame
    (wire code ``WIRE_PROTOCOL_ERROR``) and drops the connection — a
    peer speaking the wrong protocol gets a typed refusal, not a hang.
    """


register_wire_error(WIRE_PROTOCOL_ERROR, ProtocolError)


def jsonable(obj):
    """Best-effort conversion of result extras to JSON-clean values.

    numpy scalars become Python numbers, small arrays become lists,
    tuples become lists, unknown objects become ``repr`` strings — the
    wire never fails because a seeder stashed a device array in
    ``extras``.  A tensor (on any device) is copied to the host first,
    then treated as the NumPy array it holds: a 0-d one becomes a
    Python number.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return jsonable(float(obj))
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
        if obj.ndim == 0:
            return jsonable(obj[()])
    arr = getattr(obj, "__array__", None)
    if arr is not None:
        flat = np.asarray(obj)
        if flat.size <= 4096:
            return jsonable(flat.tolist())
        return f"<array shape={flat.shape} dtype={flat.dtype}>"
    return repr(obj)


def _dtype_code(arr: np.ndarray) -> int:
    kind = {4: "f32", 8: "f64"}.get(arr.dtype.itemsize)
    if arr.dtype.kind != "f" or kind is None:
        raise ProtocolError(
            f"wire payloads must be f32/f64, got dtype {arr.dtype}")
    return _DTYPE_CODES[kind]


def _np_dtype(code: int) -> np.dtype:
    name = _DTYPE_NAMES.get(code)
    if name is None:
        raise ProtocolError(f"unknown dtype code {code}")
    return _NP_DTYPES[name]


class _Body:
    """Cursor over one frame body: typed reads with truncation checks."""

    def __init__(self, buf: bytes):
        self._buf = buf
        self._pos = 0

    def unpack(self, st: struct.Struct) -> tuple:
        end = self._pos + st.size
        if end > len(self._buf):
            raise ProtocolError("truncated frame body")
        out = st.unpack_from(self._buf, self._pos)
        self._pos = end
        return out

    def take(self, n: int) -> bytes:
        end = self._pos + n
        if end > len(self._buf):
            raise ProtocolError("truncated frame body")
        out = self._buf[self._pos:end]
        self._pos = end
        return out

    def rest(self) -> bytes:
        out = self._buf[self._pos:]
        self._pos = len(self._buf)
        return out

    def done(self) -> None:
        if self._pos != len(self._buf):
            raise ProtocolError(
                f"{len(self._buf) - self._pos} trailing byte(s) after frame "
                f"body")


def _frame(frame_type: int, request_id: int, body: bytes) -> bytes:
    payload = _HEADER.pack(PROTOCOL_VERSION, frame_type,
                           request_id) + body
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame of {len(payload)} bytes exceeds MAX_FRAME_BYTES; "
            f"use a streamed upload")
    return _LENGTH.pack(len(payload)) + payload


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise ProtocolError(f"string field too long ({len(raw)} bytes)")
    return struct.pack("<H", len(raw)) + raw


def _unpack_str(body: _Body) -> str:
    (n,) = body.unpack(struct.Struct("<H"))
    return body.take(n).decode("utf-8")


def _pack_json(obj) -> bytes:
    raw = json.dumps(jsonable(obj), separators=(",", ":")).encode("utf-8")
    return struct.pack("<I", len(raw)) + raw


def _unpack_json(body: _Body):
    (n,) = body.unpack(struct.Struct("<I"))
    raw = body.take(n)
    try:
        return json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"bad JSON field: {e}") from e


# ---------------------------------------------------------------------------
# Frame dataclasses.
# ---------------------------------------------------------------------------

_SUBMIT_FIXED = struct.Struct("<BBIIiBqdi")


@dataclasses.dataclass(frozen=True)
class SubmitFrame:
    """One fit request: dtype+shape header plus the raw point buffer.

    ``payload`` is the little-endian C-order point buffer (empty when
    ``streamed`` — the bytes follow in `ChunkFrame`s).  ``k``/``seed``
    of ``None`` defer to the server frontend's `ClusterSpec`;
    ``deadline`` is seconds-from-receipt (the client's clock never
    crosses the wire — deadlines re-anchor on the server's monotonic
    clock at admission).
    """

    request_id: int
    n: int
    d: int
    dtype: str                       # "f32" | "f64"
    payload: bytes = b""
    k: Optional[int] = None
    seed: Optional[int] = None
    deadline: Optional[float] = None
    priority: int = 0
    tenant: str = "default"
    streamed: bool = False

    def expected_bytes(self) -> int:
        """Total point-buffer size the header promises."""
        return self.n * self.d * _NP_DTYPES[self.dtype].itemsize

    def points(self, payload: Optional[bytes] = None) -> np.ndarray:
        """The (n, d) point array (``payload`` overrides for streamed)."""
        raw = self.payload if payload is None else payload
        if len(raw) != self.expected_bytes():
            raise ProtocolError(
                f"point buffer is {len(raw)} bytes; header promised "
                f"{self.expected_bytes()} ({self.n}x{self.d} {self.dtype})")
        return np.frombuffer(raw, dtype=_NP_DTYPES[self.dtype]).reshape(
            self.n, self.d)

    @classmethod
    def from_points(cls, request_id: int, points: np.ndarray, *,
                    k: Optional[int] = None, seed: Optional[int] = None,
                    deadline: Optional[float] = None, priority: int = 0,
                    tenant: str = "default",
                    streamed: bool = False) -> "SubmitFrame":
        """Build a frame from an array (f32 kept, everything else f64)."""
        arr = np.ascontiguousarray(points)
        if arr.ndim != 2:
            raise ProtocolError(
                f"points must be 2-D (n, d), got shape {arr.shape}")
        if arr.dtype != np.float32:
            arr = arr.astype("<f8")
        else:
            arr = arr.astype("<f4", copy=False)
        dtype = "f32" if arr.dtype.itemsize == 4 else "f64"
        return cls(request_id=request_id, n=arr.shape[0], d=arr.shape[1],
                   dtype=dtype, payload=b"" if streamed else arr.tobytes(),
                   k=k, seed=seed, deadline=deadline, priority=priority,
                   tenant=tenant, streamed=streamed)

    def encode(self) -> bytes:
        """The complete wire frame (length prefix included)."""
        flags = _SUBMIT_FLAG_STREAMED if self.streamed else 0
        fixed = _SUBMIT_FIXED.pack(
            flags, _DTYPE_CODES[self.dtype], self.n, self.d,
            -1 if self.k is None else int(self.k),
            0 if self.seed is None else 1,
            0 if self.seed is None else int(self.seed),
            -1.0 if self.deadline is None else float(self.deadline),
            int(self.priority))
        body = fixed + _pack_str(self.tenant) + \
            (b"" if self.streamed else self.payload)
        return _frame(FRAME_SUBMIT, self.request_id, body)

    @classmethod
    def _decode(cls, request_id: int, body: _Body) -> "SubmitFrame":
        (flags, dtype_code, n, d, k, has_seed, seed, deadline,
         priority) = body.unpack(_SUBMIT_FIXED)
        dtype = _DTYPE_NAMES.get(dtype_code)
        if dtype is None:
            raise ProtocolError(f"unknown dtype code {dtype_code}")
        tenant = _unpack_str(body)
        streamed = bool(flags & _SUBMIT_FLAG_STREAMED)
        payload = b"" if streamed else body.rest()
        frame = cls(request_id=request_id, n=n, d=d, dtype=dtype,
                    payload=payload, k=None if k < 0 else k,
                    seed=seed if has_seed else None,
                    deadline=None if deadline < 0 else deadline,
                    priority=priority, tenant=tenant, streamed=streamed)
        if not streamed and len(payload) != frame.expected_bytes():
            raise ProtocolError(
                f"inline point buffer is {len(payload)} bytes; header "
                f"promised {frame.expected_bytes()}")
        return frame


_EXTEND_FIXED = struct.Struct("<BBIIBqd")


@dataclasses.dataclass(frozen=True)
class ExtendFrame:
    """One streaming append-then-refit against a named server stream.

    Layout mirrors `SubmitFrame` (dtype+shape header, inline or chunked
    point buffer) with the k/priority fields replaced by the ``stream``
    label the server keys its prepared-stream registry on.  ``n == 0``
    carries no points and asks for a refit of the stream as-is.
    Extends are applied in admission order and are **at-least-once**
    under client replay (a reconnect can re-apply a delivered extend);
    see docs/streaming.md for the mutation contract.
    """

    request_id: int
    stream: str
    n: int
    d: int
    dtype: str                       # "f32" | "f64"
    payload: bytes = b""
    seed: Optional[int] = None
    deadline: Optional[float] = None
    tenant: str = "default"
    streamed: bool = False

    def expected_bytes(self) -> int:
        """Total point-buffer size the header promises."""
        return self.n * self.d * _NP_DTYPES[self.dtype].itemsize

    def points(self, payload: Optional[bytes] = None) -> np.ndarray:
        """The (n, d) point array (``payload`` overrides for streamed)."""
        raw = self.payload if payload is None else payload
        if len(raw) != self.expected_bytes():
            raise ProtocolError(
                f"point buffer is {len(raw)} bytes; header promised "
                f"{self.expected_bytes()} ({self.n}x{self.d} {self.dtype})")
        return np.frombuffer(raw, dtype=_NP_DTYPES[self.dtype]).reshape(
            self.n, self.d)

    @classmethod
    def from_points(cls, request_id: int, stream: str, points, *,
                    seed: Optional[int] = None,
                    deadline: Optional[float] = None,
                    tenant: str = "default",
                    streamed: bool = False) -> "ExtendFrame":
        """Build a frame from an array (f32 kept, everything else f64)."""
        arr = np.ascontiguousarray(points)
        if arr.ndim != 2:
            raise ProtocolError(
                f"points must be 2-D (n, d), got shape {arr.shape}")
        if arr.dtype != np.float32:
            arr = arr.astype("<f8")
        else:
            arr = arr.astype("<f4", copy=False)
        dtype = "f32" if arr.dtype.itemsize == 4 else "f64"
        return cls(request_id=request_id, stream=stream, n=arr.shape[0],
                   d=arr.shape[1], dtype=dtype,
                   payload=b"" if streamed else arr.tobytes(),
                   seed=seed, deadline=deadline, tenant=tenant,
                   streamed=streamed)

    def encode(self) -> bytes:
        """The complete wire frame (length prefix included)."""
        flags = _SUBMIT_FLAG_STREAMED if self.streamed else 0
        fixed = _EXTEND_FIXED.pack(
            flags, _DTYPE_CODES[self.dtype], self.n, self.d,
            0 if self.seed is None else 1,
            0 if self.seed is None else int(self.seed),
            -1.0 if self.deadline is None else float(self.deadline))
        body = fixed + _pack_str(self.stream) + _pack_str(self.tenant) + \
            (b"" if self.streamed else self.payload)
        return _frame(FRAME_EXTEND, self.request_id, body)

    @classmethod
    def _decode(cls, request_id: int, body: _Body) -> "ExtendFrame":
        (flags, dtype_code, n, d, has_seed, seed,
         deadline) = body.unpack(_EXTEND_FIXED)
        dtype = _DTYPE_NAMES.get(dtype_code)
        if dtype is None:
            raise ProtocolError(f"unknown dtype code {dtype_code}")
        stream = _unpack_str(body)
        tenant = _unpack_str(body)
        streamed = bool(flags & _SUBMIT_FLAG_STREAMED)
        payload = b"" if streamed else body.rest()
        frame = cls(request_id=request_id, stream=stream, n=n, d=d,
                    dtype=dtype, payload=payload,
                    seed=seed if has_seed else None,
                    deadline=None if deadline < 0 else deadline,
                    tenant=tenant, streamed=streamed)
        if not streamed and len(payload) != frame.expected_bytes():
            raise ProtocolError(
                f"inline point buffer is {len(payload)} bytes; header "
                f"promised {frame.expected_bytes()}")
        return frame


@dataclasses.dataclass(frozen=True)
class ChunkFrame:
    """One fragment of a streamed point upload (``last`` completes it)."""

    request_id: int
    payload: bytes
    last: bool = False

    def encode(self) -> bytes:
        """The complete wire frame (length prefix included)."""
        flags = _CHUNK_FLAG_LAST if self.last else 0
        return _frame(FRAME_STREAM_CHUNK, self.request_id,
                      struct.pack("<B", flags) + self.payload)

    @classmethod
    def _decode(cls, request_id: int, body: _Body) -> "ChunkFrame":
        (flags,) = body.unpack(struct.Struct("<B"))
        return cls(request_id=request_id, payload=body.rest(),
                   last=bool(flags & _CHUNK_FLAG_LAST))


_RESULT_FIXED = struct.Struct("<BIId")


@dataclasses.dataclass(frozen=True)
class ResultFrame:
    """A served fit: indices (i64), centers (raw f32/f64), cost, extras."""

    request_id: int
    indices: np.ndarray              # (k,) int64
    centers: np.ndarray              # (k, d) f32/f64
    cost: float
    extras: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_result(cls, request_id: int, result,
                    extras: Optional[dict] = None) -> "ResultFrame":
        """Build from a host `FitResult` (``.to_numpy()`` it first)."""
        return cls(
            request_id=request_id,
            indices=np.asarray(result.indices, dtype="<i8").reshape(-1),
            centers=np.ascontiguousarray(result.centers),
            cost=float(np.asarray(result.cost)),
            extras=dict(result.extras if extras is None else extras))

    def encode(self) -> bytes:
        """The complete wire frame (length prefix included)."""
        centers = np.ascontiguousarray(self.centers)
        code = _dtype_code(centers)
        k, d = centers.shape
        body = (_RESULT_FIXED.pack(code, k, d, float(self.cost))
                + np.asarray(self.indices, dtype="<i8").tobytes()
                + centers.astype(centers.dtype.newbyteorder("<"),
                                 copy=False).tobytes()
                + _pack_json(self.extras))
        return _frame(FRAME_RESULT, self.request_id, body)

    @classmethod
    def _decode(cls, request_id: int, body: _Body) -> "ResultFrame":
        code, k, d, cost = body.unpack(_RESULT_FIXED)
        dt = _np_dtype(code)
        indices = np.frombuffer(body.take(8 * k), dtype="<i8")
        centers = np.frombuffer(body.take(dt.itemsize * k * d),
                                dtype=dt).reshape(k, d)
        extras = _unpack_json(body)
        body.done()
        return cls(request_id=request_id, indices=indices, centers=centers,
                   cost=cost, extras=extras)


@dataclasses.dataclass(frozen=True)
class StatsFrame:
    """SLO introspection: empty-body request, JSON-body response."""

    request_id: int
    payload: Optional[dict] = None   # None = request direction

    def encode(self) -> bytes:
        """The complete wire frame (length prefix included)."""
        body = b"" if self.payload is None else _pack_json(self.payload)
        return _frame(FRAME_STATS, self.request_id, body)

    @classmethod
    def _decode(cls, request_id: int, body: _Body) -> "StatsFrame":
        if not body._buf:
            return cls(request_id=request_id, payload=None)
        payload = _unpack_json(body)
        body.done()
        return cls(request_id=request_id, payload=payload)


@dataclasses.dataclass(frozen=True)
class ErrorFrame:
    """A typed failure for one request (resilience wire code + message)."""

    request_id: int
    code: int
    message: str

    @classmethod
    def from_exception(cls, request_id: int,
                       exc: BaseException) -> "ErrorFrame":
        """Serialize via the `repro_torch.core.resilience` wire taxonomy."""
        code, message = exception_to_wire(exc)
        return cls(request_id=request_id, code=code, message=message)

    def encode(self) -> bytes:
        """The complete wire frame (length prefix included)."""
        raw = self.message.encode("utf-8")[:0xFFFF]
        body = struct.pack("<H", self.code) + \
            struct.pack("<I", len(raw)) + raw
        return _frame(FRAME_ERROR, self.request_id, body)

    @classmethod
    def _decode(cls, request_id: int, body: _Body) -> "ErrorFrame":
        (code,) = body.unpack(struct.Struct("<H"))
        (n,) = body.unpack(struct.Struct("<I"))
        message = body.take(n).decode("utf-8")
        body.done()
        return cls(request_id=request_id, code=code, message=message)


_DECODERS = {
    FRAME_SUBMIT: SubmitFrame._decode,
    FRAME_RESULT: ResultFrame._decode,
    FRAME_STREAM_CHUNK: ChunkFrame._decode,
    FRAME_STATS: StatsFrame._decode,
    FRAME_ERROR: ErrorFrame._decode,
    FRAME_EXTEND: ExtendFrame._decode,
}


def decode_frame(payload: bytes):
    """Decode one frame payload (the bytes *after* the length prefix)."""
    if len(payload) < _HEADER.size:
        raise ProtocolError(f"frame payload of {len(payload)} bytes is "
                            f"shorter than the {_HEADER.size}-byte header")
    version, frame_type, request_id = _HEADER.unpack_from(payload)
    if version != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version {version} not supported "
            f"(this build speaks {PROTOCOL_VERSION})")
    decode = _DECODERS.get(frame_type)
    if decode is None:
        raise ProtocolError(f"unknown frame type {frame_type}")
    return decode(request_id, _Body(payload[_HEADER.size:]))


class FrameReader:
    """Incremental frame decoder over a byte stream.

    Feed it whatever ``recv()`` returned; it yields every complete frame
    and buffers the remainder.  One reader per connection — it is not
    thread-safe (each connection has exactly one reader thread).
    """

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> Iterator:
        """Yield the frames completed by ``data`` (raises `ProtocolError`)."""
        self._buf.extend(data)
        while True:
            if len(self._buf) < _LENGTH.size:
                return
            (length,) = _LENGTH.unpack_from(self._buf)
            if length > MAX_FRAME_BYTES:
                raise ProtocolError(
                    f"frame length prefix {length} exceeds "
                    f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})")
            if len(self._buf) < _LENGTH.size + length:
                return
            payload = bytes(self._buf[_LENGTH.size:_LENGTH.size + length])
            del self._buf[:_LENGTH.size + length]
            yield decode_frame(payload)

    def pending_bytes(self) -> int:
        """Bytes buffered toward an incomplete frame (introspection)."""
        return len(self._buf)

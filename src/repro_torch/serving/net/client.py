"""`ClusterClient`: blocking RPC client for `ClusterServer`.

One client, one TCP connection, many outstanding requests: `submit`
assigns a client-side request id, puts a ``SUBMIT`` frame (or, above
``stream_threshold_bytes``, a streamed header plus bounded
``STREAM_CHUNK`` frames) on the wire and returns the id immediately; a
dedicated reader thread resolves ``RESULT``/``ERROR`` frames into
per-request futures, **out of order**, exactly as the server delivers
them.  `result` blocks for one id, `as_completed` yields ids in
completion order — the client-side mirror of
`ClusterFrontend.as_completed`.

Failure semantics are typed and retry-safe:

* A typed server refusal (quota, backpressure, deadline, validation,
  protocol) arrives as an ``ERROR`` frame and is reconstructed with
  `repro_torch.core.exception_from_wire` — remote failures raise the *same*
  exception types as local ones (`DeadlineExceededError` from a missed
  SLO, `QuotaExceededError` from tenancy, ...).
* A broken connection triggers reconnect-and-resend: the reader thread
  redials up to ``retries`` times (exponential backoff) and replays the
  encoded frames of every still-unresolved request, keyed by the same
  client request id.  This is safe because serving is deterministic —
  a request the server already solved re-solves to a bit-identical
  result (and the server drops duplicates of ids still inflight), so a
  retry can duplicate *work* but never *answers*.  When retries are
  exhausted every pending future fails with `ServiceUnavailableError`
  and the client refuses further submits.

Timeouts: ``connect_timeout`` bounds dialing, ``read_timeout`` is the
default block in `result`/`stats` (``None`` = wait forever).  The
deadline passed to `submit` is *seconds from server receipt* — it rides
the wire and re-anchors on the server's clock, so client/server clock
skew never shrinks an SLO.  Wire format and worked examples: docs/net.md.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import itertools
import socket
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np

from repro_torch.core import (
    FitResult,
    ServiceUnavailableError,
    exception_from_wire,
)
from repro_torch.serving.net.protocol import (
    ChunkFrame,
    ErrorFrame,
    ExtendFrame,
    FrameReader,
    ProtocolError,
    ResultFrame,
    StatsFrame,
    SubmitFrame,
)

__all__ = ["ClusterClient"]

_RECV_BYTES = 1 << 16


@dataclasses.dataclass(eq=False)
class _Request:
    """One outstanding request: its future + replayable encoded frames."""

    future: cf.Future
    frames: Optional[list]           # None once resolved (no replay)


class ClusterClient:
    """Blocking client over the cluster RPC wire.

    ::

        with ClusterClient(*server.address, tenant="interactive") as cl:
            ids = [cl.submit(ds, deadline=0.5) for ds in datasets]
            for rid in cl.as_completed(ids):
                use(cl.result(rid))

    ``tenant`` is the default tenant label stamped on submits (per-call
    override available).  Thread-safe: many threads may submit and wait
    concurrently; one reader thread owns the socket lifecycle, including
    reconnect-and-resend recovery.  `result` forgets a request once
    retrieved — fetch each id exactly once.
    """

    def __init__(self, host: str, port: int, *,
                 connect_timeout: float = 5.0,
                 read_timeout: Optional[float] = None,
                 retries: int = 2, retry_backoff_s: float = 0.05,
                 tenant: str = "default",
                 stream_threshold_bytes: int = 8 << 20,
                 chunk_bytes: int = 1 << 20):
        self.host, self.port = host, port
        self.connect_timeout = connect_timeout
        self.read_timeout = read_timeout
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.tenant = tenant
        self.stream_threshold_bytes = stream_threshold_bytes
        self.chunk_bytes = chunk_bytes
        self._lock = threading.Lock()
        self._wlock = threading.Lock()
        self._reqs: dict = {}                    # request id -> _Request
        self._ids = itertools.count(1)
        self._stop = threading.Event()
        self._dead: Optional[BaseException] = None
        self._sock = self._dial()
        self._reader_thread = threading.Thread(
            target=self._read_loop, name="cluster-client-read", daemon=True)
        self._reader_thread.start()

    # -- connection management (reader thread owns recovery) ----------------

    def _dial(self) -> socket.socket:
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout)
        except OSError as e:
            raise ServiceUnavailableError(
                f"cannot reach cluster server at "
                f"{self.host}:{self.port}: {e}") from e
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _read_loop(self) -> None:
        sock = self._sock
        reader = FrameReader()
        while not self._stop.is_set():
            try:
                data = sock.recv(_RECV_BYTES)
                if not data:
                    raise ConnectionResetError(
                        "server closed the connection")
                for frame in reader.feed(data):
                    self._on_frame(frame)
            except ProtocolError as e:
                # The server is speaking a different protocol: retrying
                # the same bytes cannot help.  Fail fast and loud.
                self._shutdown(e)
                return
            except OSError as e:
                if self._stop.is_set():
                    return
                sock = self._recover(e)
                if sock is None:
                    return
                reader = FrameReader()

    def _swap_sock(self, sock: socket.socket) -> None:
        """Install a redialed socket (write lock held by the caller)."""
        old = self._sock
        self._sock = sock
        old.close()

    def _recover(self, cause: BaseException) -> Optional[socket.socket]:
        """Redial and replay every unresolved request's frames.

        Holding the write lock across snapshot-swap-replay means a
        concurrent `submit` either lands before the snapshot (its frames
        are in the replay) or after the swap (it sends on the healthy
        socket) — never lost.  A request replayed *and* re-sent is the
        duplicate the server/`_settle` already dedupe.
        """
        for attempt in range(self.retries):
            if self._stop.is_set():
                return None
            time.sleep(self.retry_backoff_s * (2 ** attempt))
            try:
                sock = self._dial()
            except ServiceUnavailableError:
                continue
            try:
                with self._wlock:
                    with self._lock:
                        replay = [list(r.frames)
                                  for r in self._reqs.values()
                                  if r.frames is not None]
                    self._swap_sock(sock)
                    for frames in replay:
                        for data in frames:
                            sock.sendall(data)
            except OSError:
                continue
            return sock
        self._shutdown(ServiceUnavailableError(
            f"connection to {self.host}:{self.port} lost and "
            f"{self.retries} reconnect attempt(s) failed: {cause}"))
        return None

    def _shutdown(self, cause: BaseException) -> None:
        """Fail every pending future with ``cause``; refuse new submits."""
        self._dead = cause
        with self._lock:
            drop = [r for r in self._reqs.values() if r.frames is not None]
            for r in drop:
                r.frames = None
        for r in drop:
            if not r.future.done():
                r.future.set_exception(cause)

    # -- frame handling (reader thread) -------------------------------------

    def _on_frame(self, frame) -> None:
        rid = frame.request_id
        if isinstance(frame, ResultFrame):
            server = frame.extras.get("server", {}) \
                if isinstance(frame.extras, dict) else {}
            result = FitResult(
                indices=np.asarray(frame.indices, dtype=np.int64),
                centers=np.asarray(frame.centers),
                cost=float(frame.cost), k=int(frame.indices.size),
                prepare_seconds=float(server.get("prepare_seconds", 0.0)),
                solve_seconds=float(server.get("solve_seconds", 0.0)),
                extras=frame.extras)
            self._settle(rid, result=result)
        elif isinstance(frame, ErrorFrame):
            self._settle(rid, error=exception_from_wire(frame.code,
                                                        frame.message))
        elif isinstance(frame, StatsFrame):
            self._settle(rid, result=frame.payload)
        else:
            raise ProtocolError(
                f"server must not send {type(frame).__name__}")

    def _settle(self, rid: int, *, result=None,
                error: Optional[BaseException] = None) -> None:
        with self._lock:
            rec = self._reqs.get(rid)
            if rec is not None:
                rec.frames = None        # resolved: never replay again
        if rec is None or rec.future.done():
            return      # late/duplicate frame for an already-settled id
        if error is not None:
            rec.future.set_exception(error)
            return
        try:
            rec.future.set_result(result)
        except BaseException as e:  # noqa: BLE001 — never strand a waiter
            if not rec.future.done():
                rec.future.set_exception(e)

    # -- public API ----------------------------------------------------------

    def submit(self, points, *, k: Optional[int] = None,
               seed: Optional[int] = None,
               deadline: Optional[float] = None, priority: int = 0,
               tenant: Optional[str] = None) -> int:
        """Send one fit request; returns its client request id immediately.

        Arguments mirror `ClusterFrontend.submit`; ``deadline`` is
        seconds from *server receipt*.  Large point sets (above
        ``stream_threshold_bytes``) go as a chunked streamed upload.
        The id is the retry key: recovery replays the identical frames
        under the same id, and determinism makes any duplicate solve
        bit-identical.
        """
        tenant = self.tenant if tenant is None else tenant
        rid = next(self._ids)
        arr = np.ascontiguousarray(points)
        nbytes = arr.size * (4 if arr.dtype == np.float32 else 8)
        if nbytes <= self.stream_threshold_bytes:
            head = SubmitFrame.from_points(
                rid, arr, k=k, seed=seed, deadline=deadline,
                priority=priority, tenant=tenant)
            frames = [head.encode()]
        else:
            head = SubmitFrame.from_points(
                rid, arr, k=k, seed=seed, deadline=deadline,
                priority=priority, tenant=tenant, streamed=True)
            frames = [head.encode()]
            raw = (arr.astype("<f4", copy=False) if arr.dtype == np.float32
                   else arr.astype("<f8")).tobytes()
            for off in range(0, len(raw), self.chunk_bytes):
                chunk = raw[off:off + self.chunk_bytes]
                frames.append(ChunkFrame(
                    rid, chunk,
                    last=off + self.chunk_bytes >= len(raw)).encode())
        return self._register_as(rid, frames)

    def extend(self, points, *, stream: str = "default",
               seed: Optional[int] = None,
               deadline: Optional[float] = None,
               tenant: Optional[str] = None) -> int:
        """Send one streaming extend-then-refit; returns its request id.

        ``stream`` names the server-side stream: the first `extend` for
        a label creates it from this batch (and the refit's RESULT
        comes back like any fit); later calls append to it in server
        admission order.  ``points=None`` refits the stream without
        appending (the remote drift-reseed nudge; the stream must
        already exist).  Unlike `submit`, an extend is a *mutation* —
        the reconnect-and-resend retry loop makes it at-least-once, so
        a replay after a lost RESULT can append the batch twice (see
        docs/streaming.md before retrying extends aggressively).
        Large batches stream as chunks exactly like `submit`.
        """
        tenant = self.tenant if tenant is None else tenant
        rid = next(self._ids)
        if points is None:
            head = ExtendFrame(request_id=rid, stream=stream, n=0, d=0,
                               dtype="f64", seed=seed, deadline=deadline,
                               tenant=tenant)
            return self._register_as(rid, [head.encode()])
        arr = np.ascontiguousarray(points)
        nbytes = arr.size * (4 if arr.dtype == np.float32 else 8)
        if nbytes <= self.stream_threshold_bytes:
            head = ExtendFrame.from_points(
                rid, stream, arr, seed=seed, deadline=deadline,
                tenant=tenant)
            frames = [head.encode()]
        else:
            head = ExtendFrame.from_points(
                rid, stream, arr, seed=seed, deadline=deadline,
                tenant=tenant, streamed=True)
            frames = [head.encode()]
            raw = (arr.astype("<f4", copy=False) if arr.dtype == np.float32
                   else arr.astype("<f8")).tobytes()
            for off in range(0, len(raw), self.chunk_bytes):
                chunk = raw[off:off + self.chunk_bytes]
                frames.append(ChunkFrame(
                    rid, chunk,
                    last=off + self.chunk_bytes >= len(raw)).encode())
        return self._register_as(rid, frames)

    def _register_as(self, rid: int, frames: list) -> int:
        """Record request ``rid`` and put its frames on the wire."""
        if self._dead is not None:
            raise ServiceUnavailableError(
                f"client is closed after unrecoverable failure: "
                f"{self._dead}")
        rec = _Request(future=cf.Future(), frames=frames)
        with self._lock:
            self._reqs[rid] = rec
        try:
            with self._wlock:
                for data in frames:
                    self._sock.sendall(data)
        except OSError:
            # The reader thread owns recovery: it will observe the dead
            # socket and replay this request's frames after redialing
            # (or fail the future if retries run out).
            pass
        return rid

    def result(self, request_id: int,
               timeout: Optional[float] = None):
        """Block for one request's `FitResult` (or raise its typed error).

        ``timeout`` defaults to the client's ``read_timeout``.  The
        request is forgotten once retrieved — call exactly once per id.
        """
        with self._lock:
            rec = self._reqs.get(request_id)
        if rec is None:
            raise KeyError(f"unknown or already-retrieved request id "
                           f"{request_id}")
        out = rec.future.result(
            self.read_timeout if timeout is None else timeout)
        with self._lock:
            self._reqs.pop(request_id, None)
        return out

    def as_completed(self, request_ids: Iterable[int],
                     timeout: Optional[float] = None) -> Iterator[int]:
        """Yield request ids as their terminal frames arrive."""
        with self._lock:
            by_future = {self._reqs[rid].future: rid
                         for rid in request_ids}
        for fut in cf.as_completed(by_future, timeout=timeout):
            yield by_future[fut]

    def stats(self, timeout: Optional[float] = None) -> dict:
        """The server's `ClusterServer.stats` dict (one STATS round-trip)."""
        rid = next(self._ids)
        self._register_as(rid, [StatsFrame(rid).encode()])
        return self.result(rid, timeout=timeout)

    def close(self) -> None:
        """Tear the connection down; pending futures fail typed."""
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader_thread.join()
        self._shutdown(ServiceUnavailableError("client closed"))

    def __enter__(self) -> "ClusterClient":
        """Context manager entry: the (connected) client."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Close the connection on exit."""
        self.close()

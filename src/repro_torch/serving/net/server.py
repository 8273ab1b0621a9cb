"""`ClusterServer`: the wire front door over a `ClusterFrontend`.

One server, one listening socket, many clients: each accepted connection
gets a dedicated reader thread that decodes frames
(`repro_torch.serving.net.protocol`), admits ``SUBMIT`` requests into the
shared `ClusterFrontend` (which coalesces them into stacked lanes across
*all* connections — the whole point of putting the transport here rather
than over a bare engine), and delivers ``RESULT``/``ERROR`` frames as
tickets resolve — **out of order**, each from the resolving ticket's own
done-callback, so one slow lane never head-of-line-blocks a fast one on
the same connection.

Delivery discipline mirrors the frontend's future discipline: every
accepted request id gets exactly one terminal frame on every exit path —
`send_result` is always covered by a ``BaseException`` handler that
forwards to `send_error` on the same connection (the wire twin of the
``set_result``/``set_exception`` pairing the ``future-discipline``
analysis rule enforces), and `send_error` itself never raises (a peer
that vanished mid-delivery costs nothing but the frame; the frontend
ledger still balances because tickets resolve server-side regardless of
delivery).  Large uploads arrive as a ``SUBMIT`` flagged *streamed*
followed by bounded ``STREAM_CHUNK`` frames, staged per-connection and
admitted whole.  Duplicate request ids on one connection are idempotent:
a duplicate of an *inflight* id is dropped (the original will deliver),
a resubmit after delivery re-solves — deterministic seeding makes the
re-solve bit-identical, which is what makes the client's
reconnect-and-resend retry loop safe.

``STATS`` answers with `stats()`: the frontend ledger (including
per-tenant counters and queue-wait percentiles), the admission
scheduler's token/vtime state, and a ``net`` section with connection
counters plus the cumulative queue_wait vs solve vs network time
breakdown.  Multi-tenant admission is the frontend's ``admission`` hook
(`repro_torch.serving.net.tenancy.TenantScheduler`); the server just carries
each frame's tenant label through.  Operational guide: docs/net.md.
"""

from __future__ import annotations

import collections
import socket
import threading
import time
from typing import Any, Callable, Optional, Tuple

from repro_torch.core import ClusterSpec, ExecutionSpec
from repro_torch.serving.frontend import ClusterFrontend
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

__all__ = ["ClusterServer"]

#: recv() buffer size for connection reader threads.
_RECV_BYTES = 1 << 16


class _Connection:
    """One accepted client socket: framed writes + inflight request ids.

    Writes are serialised by a per-connection lock (ticket done-callbacks
    fire from engine threads concurrently); the inflight set makes
    duplicate request ids idempotent.  After `close` every send is a
    silent no-op — the terminal-frame contract is "best effort delivery,
    exactly-once resolution", and resolution happens in the frontend.
    """

    def __init__(self, sock: socket.socket, peer: Tuple[str, int]):
        self._sock = sock
        self.peer = peer
        self._wlock = threading.Lock()
        self._ilock = threading.Lock()
        self._inflight: set = set()
        self._closed = threading.Event()

    # -- inflight ids -------------------------------------------------------

    def try_begin(self, request_id: int) -> bool:
        """Claim a request id; False if it is already inflight (duplicate)."""
        with self._ilock:
            if request_id in self._inflight:
                return False
            self._inflight.add(request_id)
            return True

    def finish(self, request_id: int) -> None:
        """Release a request id once its terminal frame went out."""
        with self._ilock:
            self._inflight.discard(request_id)

    # -- framed writes ------------------------------------------------------

    def _send(self, data: bytes) -> None:
        if self._closed.is_set():
            raise OSError("connection closed")
        with self._wlock:
            self._sock.sendall(data)

    def send_result(self, request_id: int, result, extras: dict) -> None:
        """Deliver one RESULT frame (raises on a dead peer — callers pair
        this with `send_error` per the wire future-discipline)."""
        self._send(ResultFrame.from_result(
            request_id, result, extras=extras).encode())

    def send_error(self, request_id: int, exc: BaseException) -> None:
        """Deliver one typed ERROR frame; never raises (peer may be gone)."""
        try:
            self._send(ErrorFrame.from_exception(request_id, exc).encode())
        except BaseException:  # noqa: BLE001 — delivery is best-effort
            pass

    def send_stats(self, request_id: int, payload: dict) -> None:
        """Deliver one STATS response frame."""
        self._send(StatsFrame(request_id, payload=payload).encode())

    def close(self) -> None:
        """Tear the socket down; subsequent sends become no-ops."""
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class ClusterServer:
    """Serve a `ClusterFrontend` over a length-prefixed binary socket RPC.

    ::

        scheduler = TenantScheduler(parse_tenants("bulk:50,rt:200:40:4"))
        with ClusterServer(ClusterSpec(k=16, seeder="fastkmeans++"),
                           ExecutionSpec(backend="device"),
                           admission=scheduler, port=7077) as srv:
            print("listening on", srv.address)
            srv.wait_closed()

    By default the server owns a private `ClusterFrontend` built from
    ``cluster``/``execution`` and the ``max_batch`` / ``max_wait_ms`` /
    ``max_pending`` / ``backpressure`` knobs, with ``admission`` as its
    multi-tenant hook.  Pass ``frontend=`` to share an existing frontend
    instead (the server then never closes it, and ``admission`` defaults
    to the frontend's own hook).  `start` happens in the constructor:
    the listening socket is bound (``port=0`` picks a free port —
    `address` has the outcome) and the accept loop runs on a daemon
    thread.  `close` stops accepting, tears down client connections,
    and drains the owned frontend.
    """

    def __init__(self, cluster: Optional[ClusterSpec] = None,
                 execution: Optional[ExecutionSpec] = None, *,
                 frontend: Optional[ClusterFrontend] = None,
                 admission: Optional[Any] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 max_pending: Optional[int] = None,
                 backpressure: str = "block",
                 clock: Callable[[], float] = time.monotonic):
        if frontend is not None:
            self._frontend, self._own_frontend = frontend, False
            self.admission = admission if admission is not None \
                else frontend.admission
        else:
            self._frontend = ClusterFrontend(
                cluster, execution, max_batch=max_batch,
                max_wait_ms=max_wait_ms, max_pending=max_pending,
                backpressure=backpressure, admission=admission, clock=clock)
            self._own_frontend = True
            self.admission = admission
        self._clock = clock
        self._lock = threading.Lock()
        # Stream label -> streaming PreparedData handle.  Get-or-create
        # happens under one lock so two connections racing the same
        # label build one stream; creation (`prepare_streaming`) runs on
        # the creating connection's reader thread, a one-time cost.
        self._streams: dict = {}
        self._slock = threading.Lock()
        self._counters: collections.Counter = collections.Counter()
        self._breakdown = {"queue_wait_s": 0.0, "solve_s": 0.0,
                           "network_s": 0.0}
        self._conns: set = set()
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port))
        self.address: Tuple[str, int] = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="cluster-server-accept",
            daemon=True)
        self._accept_thread.start()

    # -- accept / per-connection loops --------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, peer = self._listener.accept()
            except OSError:
                return                   # listener closed: shutting down
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(sock, peer)
            self._conns.add(conn)
            with self._lock:
                self._counters["connections_total"] += 1
            threading.Thread(
                target=self._serve_connection, args=(conn,),
                name=f"cluster-server-conn-{peer[1]}", daemon=True).start()

    def _serve_connection(self, conn: _Connection) -> None:
        """Read frames off one connection until EOF/error; then clean up."""
        reader = FrameReader()
        staging: dict = {}        # request_id -> [SubmitFrame, bytearray]
        last_id = 0
        try:
            while not self._stop.is_set():
                data = conn._sock.recv(_RECV_BYTES)
                if not data:
                    return               # orderly EOF from the peer
                with self._lock:
                    self._counters["bytes_in"] += len(data)
                for frame in reader.feed(data):
                    last_id = frame.request_id
                    self._handle(conn, staging, frame)
        except ProtocolError as e:
            # A peer speaking garbage gets one typed refusal, then the
            # connection drops — never a hang, never an OOM.
            conn.send_error(last_id, e)
        except OSError:
            pass                         # peer reset / socket torn down
        finally:
            conn.close()
            self._conns.discard(conn)

    def _handle(self, conn: _Connection, staging: dict, frame) -> None:
        """Dispatch one decoded frame (reader thread only)."""
        rid = frame.request_id
        if isinstance(frame, (SubmitFrame, ExtendFrame)):
            if frame.streamed:
                if rid in staging:
                    raise ProtocolError(
                        f"request {rid}: streamed upload restarted "
                        f"mid-stream")
                staging[rid] = [frame, bytearray()]
                return
            self._dispatch_points(conn, frame, frame.points())
        elif isinstance(frame, ChunkFrame):
            st = staging.get(rid)
            if st is None:
                raise ProtocolError(
                    f"request {rid}: STREAM_CHUNK without a streamed "
                    f"SUBMIT/EXTEND header")
            head, buf = st
            buf.extend(frame.payload)
            if len(buf) > head.expected_bytes():
                raise ProtocolError(
                    f"request {rid}: streamed upload overran the header "
                    f"({len(buf)} > {head.expected_bytes()} bytes)")
            if frame.last:
                del staging[rid]
                self._dispatch_points(conn, head, head.points(bytes(buf)))
        elif isinstance(frame, StatsFrame):
            if frame.payload is not None:
                raise ProtocolError(
                    "STATS with a payload is a response frame; clients "
                    "send the empty-body request direction")
            try:
                conn.send_stats(rid, self.stats())
            except BaseException as e:  # noqa: BLE001 — typed refusal
                conn.send_error(rid, e)
        else:
            raise ProtocolError(
                f"clients must not send {type(frame).__name__}")

    # -- admission / delivery ------------------------------------------------

    def _dispatch_points(self, conn: _Connection, frame, points) -> None:
        """Route one complete header+buffer to its admission path."""
        if isinstance(frame, ExtendFrame):
            self._admit_extend(conn, frame, points)
        else:
            self._admit(conn, frame, points)

    def _admit_extend(self, conn: _Connection, frame: ExtendFrame,
                      points) -> None:
        """Feed one complete EXTEND into the frontend; arrange delivery.

        The first EXTEND for a stream label creates the server-side
        stream from its batch (`ClusterPlan.prepare_streaming`, on this
        reader thread) and refits it; later EXTENDs append in admission
        order.  Duplicate-id handling matches SUBMIT — but note an
        extend is a *mutation*, so a client replay after a delivered
        result re-applies it (at-least-once; docs/streaming.md).
        """
        rid = frame.request_id
        if not conn.try_begin(rid):
            with self._lock:
                self._counters["duplicates_dropped"] += 1
            return
        t_recv = self._clock()
        try:
            pts = None if frame.n == 0 else points
            with self._slock:
                prep = self._streams.get(frame.stream)
                if prep is None:
                    if pts is None:
                        raise ValueError(
                            f"stream {frame.stream!r} does not exist; the "
                            f"creating EXTEND must carry points (n > 0)")
                    plan = self._frontend.engine.plan_for(
                        self._frontend.cluster)
                    prep = plan.prepare_streaming(pts)
                    self._streams[frame.stream] = prep
                    pts = None       # creation consumed the batch
            ticket = self._frontend.submit_extend(
                pts, prepared=prep, seed=frame.seed,
                deadline=frame.deadline, tenant=frame.tenant)
        except BaseException as e:  # noqa: BLE001 — typed wire refusal
            conn.finish(rid)
            with self._lock:
                self._counters["errors_sent"] += 1
            conn.send_error(rid, e)
            return
        with self._lock:
            self._counters["requests_admitted"] += 1
            self._counters["extends_admitted"] += 1
        submitted_at = self._clock()
        ticket.add_done_callback(
            lambda t, conn=conn, rid=rid, t_recv=t_recv,
            submitted_at=submitted_at:
                self._deliver(conn, rid, t_recv, submitted_at, t))

    def _admit(self, conn: _Connection, frame: SubmitFrame, points) -> None:
        """Feed one complete SUBMIT into the frontend; arrange delivery."""
        rid = frame.request_id
        if not conn.try_begin(rid):
            # Duplicate of an inflight id (client retry racing the
            # result): the original delivery answers both.
            with self._lock:
                self._counters["duplicates_dropped"] += 1
            return
        t_recv = self._clock()
        try:
            ticket = self._frontend.submit(
                points, k=frame.k, seed=frame.seed,
                deadline=frame.deadline, priority=frame.priority,
                tenant=frame.tenant)
        except BaseException as e:  # noqa: BLE001 — typed wire refusal
            conn.finish(rid)
            with self._lock:
                self._counters["errors_sent"] += 1
            conn.send_error(rid, e)
            return
        with self._lock:
            self._counters["requests_admitted"] += 1
        submitted_at = self._clock()
        ticket.add_done_callback(
            lambda t, conn=conn, rid=rid, t_recv=t_recv,
            submitted_at=submitted_at:
                self._deliver(conn, rid, t_recv, submitted_at, t))

    def _deliver(self, conn: _Connection, rid: int, t_recv: float,
                 submitted_at: float, ticket) -> None:
        """Terminal frame for one resolved ticket (engine thread).

        Runs out-of-order across a connection's requests — each ticket
        delivers the moment it resolves.  Exactly one of
        RESULT/ERROR goes out per accepted id on every path.
        """
        t_done = self._clock()
        try:
            exc = ticket.exception()
            if exc is not None:
                with self._lock:
                    self._counters["errors_sent"] += 1
                conn.send_error(rid, exc)
                return
            res = ticket.result().to_numpy()
            queue_wait = float(res.extras.get("queue_wait", 0.0))
            extras = dict(res.extras)
            extras["server"] = {
                "queue_wait": queue_wait,
                "prepare_seconds": res.prepare_seconds,
                "solve_seconds": res.solve_seconds,
                "recv_to_submit": submitted_at - t_recv,
            }
            conn.send_result(rid, res, extras)
            t_sent = self._clock()
            with self._lock:
                self._counters["results_sent"] += 1
                self._breakdown["queue_wait_s"] += queue_wait
                self._breakdown["solve_s"] += \
                    res.prepare_seconds + res.solve_seconds
                self._breakdown["network_s"] += \
                    (submitted_at - t_recv) + (t_sent - t_done)
        except BaseException as e:  # noqa: BLE001 — wire future-discipline
            with self._lock:
                self._counters["errors_sent"] += 1
            conn.send_error(rid, e)
        finally:
            conn.finish(rid)

    # -- introspection / lifecycle ------------------------------------------

    def stats(self) -> dict:
        """Frontend ledger + ``tenancy`` scheduler state + ``net`` section.

        ``net`` carries connection/request/byte counters and
        ``breakdown`` — cumulative seconds attributed to queue wait
        (coalescing hold), solve (prepare + device solve) and network
        (decode-to-admit plus result serialisation/send) across all
        served results; the SLO attribution the launcher's smoke mode
        prints.
        """
        s = self._frontend.stats()
        with self._lock:
            net: dict = dict(self._counters)
            net["breakdown"] = dict(self._breakdown)
        for key in ("connections_total", "requests_admitted",
                    "extends_admitted", "results_sent", "errors_sent",
                    "duplicates_dropped", "bytes_in"):
            net.setdefault(key, 0)
        net["connections_active"] = len(self._conns)
        with self._slock:
            net["streams"] = len(self._streams)
        s["net"] = net
        if self.admission is not None and hasattr(self.admission, "stats"):
            s["tenancy"] = self.admission.stats()
        return s

    def wait_closed(self, timeout: Optional[float] = None) -> bool:
        """Block until `close` is called (e.g. under a signal handler)."""
        return self._stop.wait(timeout)

    def close(self, cancel_pending: bool = False) -> None:
        """Stop accepting, drop client connections, drain the frontend.

        An owned frontend is closed (draining held lanes, or cancelling
        them with ``cancel_pending=True``); a shared frontend is left
        running.  Idempotent.
        """
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            # close() alone does not wake a thread blocked in accept();
            # shutdown() does.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        for conn in list(self._conns):
            conn.close()
        self._accept_thread.join()
        if self._own_frontend:
            self._frontend.close(cancel_pending=cancel_pending)

    def __enter__(self) -> "ClusterServer":
        """Context manager entry: the (already listening) server."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Close on exit (cancel pending lanes if an error unwound)."""
        self.close(cancel_pending=exc_type is not None)

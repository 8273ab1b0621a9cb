"""The port's wire transport against the JAX package's, and the contracts
of `tests/test_net.py` on the port, on the CPU.

  * every frame the port encodes is the JAX package's bytes for the same
    inputs, and each package decodes the other's frames (property tests);
    `jsonable` treats a tensor as the NumPy array it holds;
  * the port's `ClusterServer` answers the JAX package's `ClusterClient`
    over loopback on the cpu backend, and the port's client the JAX
    package's server, each with a direct fit's indices;
  * the loopback result equals a direct `ClusterFrontend.submit` bit for
    bit (device backend, the kernels' plain versions); streamed uploads,
    typed deadline expiry, tenant quotas, malformed frames, a mid-stream
    disconnect, duplicate request ids and the EXTEND frame.

Every test that starts a thread or a socket has its own time limit.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro.serving.net as jnet
from repro.serving.net import protocol as jproto
from repro_torch.core import (
    ClusterPlan,
    ClusterSpec,
    DeadlineExceededError,
    ExecutionSpec,
    exception_from_wire,
    exception_to_wire,
)
from repro_torch.core.resilience import (
    WIRE_DEADLINE_EXCEEDED,
    WIRE_PROTOCOL_ERROR,
    WIRE_QUOTA_EXCEEDED,
)
from repro_torch.serving.frontend import ClusterFrontend
from repro_torch.serving.net import (
    ClusterClient,
    ClusterServer,
    ProtocolError,
    QuotaExceededError,
    TenantPolicy,
    TenantScheduler,
    decode_frame,
    parse_tenants,
)
from repro_torch.serving.net import protocol as proto
from repro_torch.serving.net import server as server_mod
from repro_torch.serving.net.protocol import (
    ChunkFrame,
    ErrorFrame,
    ExtendFrame,
    FrameReader,
    ResultFrame,
    StatsFrame,
    SubmitFrame,
    jsonable,
)

SPEC = ClusterSpec(k=4, seeder="fastkmeans++", seed=3)
CPU = ExecutionSpec(backend="cpu", device="cpu")
DEV = ExecutionSpec(backend="device", device="cpu")
LIMIT = 120


def _mixture(n, d=6, k_true=5, seed=0):
    """The JAX suite's mixture (`tests/test_net.py`)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 25
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _reframe(encoded: bytes, chunk: int, reader_cls=FrameReader):
    reader = reader_cls()
    out = []
    for off in range(0, len(encoded), chunk):
        out.extend(reader.feed(encoded[off:off + chunk]))
    assert reader.pending_bytes() == 0
    return out


def _cross(frame_bytes: bytes, jframe_bytes: bytes) -> tuple:
    """The same bytes from both packages; each decodes the other's."""
    assert frame_bytes == jframe_bytes
    return (decode_frame(jframe_bytes[4:]),
            jproto.decode_frame(frame_bytes[4:]))


# -- the frames, byte for byte ------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(st.integers(0, 48), st.integers(1, 8), st.booleans(),
       st.integers(0, 2**63 - 1), st.one_of(st.none(), st.integers(1, 99)),
       st.one_of(st.none(), st.integers(0, 2**31 - 1)),
       st.one_of(st.none(), st.floats(0.001, 100.0)),
       st.integers(-5, 5), st.text(max_size=12), st.booleans())
def test_submit_frame_bytes_match_jax_package(n, d, f32, rid, k, seed,
                                              deadline, priority, tenant,
                                              streamed):
    rng = np.random.default_rng(n * 131 + d)
    pts = rng.normal(size=(n, d)).astype("<f4" if f32 else "<f8")
    kw = dict(k=k, seed=seed, deadline=deadline, priority=priority,
              tenant=tenant, streamed=streamed)
    mine = SubmitFrame.from_points(rid, pts, **kw)
    theirs = jproto.SubmitFrame.from_points(rid, pts, **kw)
    back, jback = _cross(mine.encode(), theirs.encode())
    for got in (back, jback):
        assert (got.request_id, got.k, got.seed, got.priority, got.tenant,
                got.streamed, got.dtype) == (rid, k, seed, priority, tenant,
                                             streamed, mine.dtype)
    if not streamed:
        np.testing.assert_array_equal(back.points(), pts)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 32), st.integers(1, 6), st.booleans(),
       st.integers(0, 2**63 - 1), st.text(max_size=10),
       st.one_of(st.none(), st.integers(0, 2**31 - 1)), st.booleans())
def test_extend_frame_bytes_match_jax_package(n, d, f32, rid, stream, seed,
                                              streamed):
    pts = np.random.default_rng(n + 7 * d).normal(size=(n, d)).astype(
        "<f4" if f32 else "<f8")
    kw = dict(seed=seed, deadline=2.5, tenant="t", streamed=streamed)
    back, _ = _cross(ExtendFrame.from_points(rid, stream, pts, **kw).encode(),
                     jproto.ExtendFrame.from_points(rid, stream, pts,
                                                    **kw).encode())
    assert (back.stream, back.n, back.d, back.seed) == (stream, n, d, seed)
    refit = ExtendFrame(request_id=rid, stream=stream, n=0, d=0, dtype="f64")
    _cross(refit.encode(), jproto.ExtendFrame(
        request_id=rid, stream=stream, n=0, d=0, dtype="f64").encode())


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 16), st.integers(1, 8), st.booleans(),
       st.floats(-1e30, 1e30), st.integers(1, 97))
def test_result_frame_bytes_match_jax_package(k, d, f32, cost, chunk):
    rng = np.random.default_rng(k * 17 + d)
    centers = rng.normal(size=(k, d)).astype("<f4" if f32 else "<f8")
    indices = rng.integers(0, 1 << 40, size=k).astype("<i8")
    extras = {"queue_wait": 0.5, "t": "x", "seeds": (1, 2),
              "trials": np.arange(k, dtype=np.int32), "nan": float("nan"),
              "big": np.zeros(5000, np.float32)}
    mine = ResultFrame(9, indices=indices, centers=centers, cost=cost,
                       extras=extras)
    theirs = jproto.ResultFrame(9, indices=indices, centers=centers,
                                cost=cost, extras=extras)
    back, jback = _cross(mine.encode(), theirs.encode())
    (again,) = _reframe(mine.encode(), chunk)
    for got in (back, jback, again):
        np.testing.assert_array_equal(got.indices, indices)
        np.testing.assert_array_equal(got.centers, centers)
        assert got.centers.dtype == centers.dtype and got.cost == cost
        assert got.extras["trials"] == list(range(k))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 500), st.integers(1, 64))
def test_chunk_frames_match_jax_package_and_reassemble(total, chunk_bytes):
    payload = np.random.default_rng(total).bytes(total)
    mine = [ChunkFrame(5, payload[o:o + chunk_bytes],
                       last=o + chunk_bytes >= total).encode()
            for o in range(0, total, chunk_bytes)]
    theirs = [jproto.ChunkFrame(5, payload[o:o + chunk_bytes],
                                last=o + chunk_bytes >= total).encode()
              for o in range(0, total, chunk_bytes)]
    assert mine == theirs
    got = _reframe(b"".join(mine), 13)
    assert b"".join(f.payload for f in got) == payload
    assert [f.last for f in got][-1] is True
    assert all(not f.last for f in got[:-1])


def test_stats_and_error_frames_match_jax_package():
    payload = {"a": [1, 2], "net": {"x": 0.5}}
    _cross(StatsFrame(1).encode(), jproto.StatsFrame(1).encode())
    _, jback = _cross(StatsFrame(1, payload=payload).encode(),
                      jproto.StatsFrame(1, payload=payload).encode())
    assert jback.payload == payload
    for exc, jexc in ((DeadlineExceededError("too slow"),
                       jcore.DeadlineExceededError("too slow")),
                      (KeyError("k"), KeyError("k")),
                      (ProtocolError("bad"), jnet.ProtocolError("bad")),
                      (QuotaExceededError("over"),
                       jnet.QuotaExceededError("over"))):
        back, jback = _cross(ErrorFrame.from_exception(3, exc).encode(),
                             jproto.ErrorFrame.from_exception(3,
                                                              jexc).encode())
        assert type(exception_from_wire(back.code, back.message)).__name__ \
            == type(jcore.exception_from_wire(jback.code,
                                              jback.message)).__name__
    code, msg = exception_to_wire(DeadlineExceededError("too slow"))
    assert code == WIRE_DEADLINE_EXCEEDED
    assert isinstance(exception_from_wire(WIRE_QUOTA_EXCEEDED, "q"),
                      QuotaExceededError)
    assert isinstance(exception_from_wire(WIRE_PROTOCOL_ERROR, "p"),
                      ProtocolError)
    assert proto.PROTOCOL_VERSION == jproto.PROTOCOL_VERSION
    assert proto.MAX_FRAME_BYTES == jproto.MAX_FRAME_BYTES


def test_jsonable_treats_a_tensor_as_its_array():
    cases = [torch.tensor(3), torch.tensor(2.5), torch.tensor(True),
             torch.arange(6, dtype=torch.int32).reshape(2, 3),
             torch.linspace(0, 1, 7), torch.zeros(5000),
             torch.tensor(float("inf"))]
    for t in cases:
        assert jsonable(t) == jproto.jsonable(t.numpy()), t
    assert jsonable({"a": (torch.tensor(1), np.int64(2))}) == {"a": [1, 2]}


def test_malformed_frames_raise_protocol_error():
    good = StatsFrame(1).encode()
    with pytest.raises(ProtocolError, match="version"):
        decode_frame(b"\x63" + good[5:])
    with pytest.raises(ProtocolError, match="frame type"):
        decode_frame(good[4:5] + b"\x2a" + good[6:])
    with pytest.raises(ProtocolError, match="truncated"):
        decode_frame(SubmitFrame.from_points(
            1, np.zeros((4, 2))).encode()[4:30])
    with pytest.raises(ProtocolError, match="promised"):
        decode_frame(SubmitFrame.from_points(
            1, np.zeros((4, 2))).encode()[4:-9])
    with pytest.raises(ProtocolError, match="MAX_FRAME_BYTES"):
        list(FrameReader().feed(struct.pack("<I", 0xFFFFFFF0)))


def test_parse_tenants_matches_jax_package():
    spec = "bulk:50:100:1, rt:200:40:4 ,free,inf:inf"
    mine, theirs = parse_tenants(spec), jnet.parse_tenants(spec)
    assert {k: vars(v) for k, v in mine.items()} == \
        {k: vars(v) for k, v in theirs.items()}
    assert mine["rt"] == TenantPolicy(rate_hz=200, burst=40, weight=4)
    with pytest.raises(ValueError, match="tenants entry"):
        parse_tenants("a:1:2:3:4")


# -- across the packages, over loopback ---------------------------------------

def _wait_results_sent(srv, n):
    """Counters bump just after the frame hits the wire: poll briefly, as
    `tests/test_net.py` does."""
    t0 = time.monotonic()
    while srv.stats()["net"]["results_sent"] < n:
        assert time.monotonic() - t0 < 30, srv.stats()["net"]
        time.sleep(0.01)


def _direct_cpu_fit(pts, seed):
    plan = ClusterPlan(SPEC, CPU)
    return plan.fit_prepared(plan.prepare_data(pts), seed=seed)


@pytest.mark.timeout(LIMIT)
def test_port_server_answers_the_jax_client():
    datasets = [_mixture(300 + 60 * i, seed=i) for i in range(3)]
    seeds = [None, 101, 102]
    with ClusterServer(SPEC, CPU, max_batch=4, max_wait_ms=5.0) as srv:
        with jnet.ClusterClient(*srv.address) as client:
            ids = [client.submit(ds, seed=s)
                   for ds, s in zip(datasets, seeds)]
            wire = [client.result(rid, timeout=60) for rid in ids]
            _wait_results_sent(srv, 3)
            stats = client.stats(timeout=60)
    for ds, s, got in zip(datasets, seeds, wire):
        want = _direct_cpu_fit(ds, s)
        np.testing.assert_array_equal(got.indices, want.indices.numpy())
        np.testing.assert_array_equal(got.centers, want.centers.numpy())
        assert got.cost == float(want.cost)
    assert stats["completed"] == 3 and stats["net"]["results_sent"] == 3


@pytest.mark.timeout(LIMIT)
def test_results_sent_counts_after_the_frame_is_written(monkeypatch):
    """The server bumps ``results_sent`` after the RESULT frame is on the
    wire, as the JAX server does: a STATS answered between the two reads
    one short.  Holding the third delivery just after its frame is written
    makes that window certain; `_wait_results_sent` closes it."""
    real = server_mod._Connection.send_result
    release = threading.Event()
    sent = []

    def held(self, request_id, result, extras):
        real(self, request_id, result, extras)
        sent.append(request_id)
        if len(sent) == 3:
            release.wait(timeout=30)

    monkeypatch.setattr(server_mod._Connection, "send_result", held)
    datasets = [_mixture(300 + 60 * i, seed=i) for i in range(3)]
    with ClusterServer(SPEC, CPU, max_batch=4, max_wait_ms=5.0) as srv:
        with jnet.ClusterClient(*srv.address) as client:
            ids = [client.submit(ds) for ds in datasets]
            for rid in ids:
                client.result(rid, timeout=60)
            early = client.stats(timeout=60)
            release.set()
            _wait_results_sent(srv, 3)
            late = client.stats(timeout=60)
    assert early["completed"] == 3 and early["net"]["results_sent"] < 3
    assert late["completed"] == 3 and late["net"]["results_sent"] == 3


@pytest.mark.timeout(LIMIT)
def test_port_client_reaches_the_jax_server():
    datasets = [_mixture(300 + 60 * i, seed=10 + i) for i in range(3)]
    seeds = [None, 5, 6]
    with jnet.ClusterServer(jcore.ClusterSpec(k=4, seeder="fastkmeans++",
                                              seed=3),
                            jcore.ExecutionSpec(backend="cpu"),
                            max_batch=4, max_wait_ms=5.0) as srv:
        with ClusterClient(*srv.address, stream_threshold_bytes=4096,
                           chunk_bytes=1000) as client:
            ids = [client.submit(ds, seed=s)
                   for ds, s in zip(datasets, seeds)]
            wire = [client.result(rid, timeout=60) for rid in ids]
    for ds, s, got in zip(datasets, seeds, wire):
        want = _direct_cpu_fit(ds, s)
        np.testing.assert_array_equal(got.indices, want.indices.numpy())
        assert isinstance(got.indices, np.ndarray)
        assert "server" in got.extras


# -- loopback serving (the contracts of tests/test_net.py) --------------------

@pytest.mark.timeout(LIMIT)
@pytest.mark.parametrize("exe", [CPU, DEV], ids=["cpu", "device"])
def test_loopback_bit_identical_to_direct_frontend_submit(exe):
    datasets = [_mixture(300 + 60 * i, seed=i) for i in range(3)]
    with ClusterFrontend(SPEC, exe, max_batch=4, max_wait_ms=5.0) as fe:
        direct = []
        for i, ds in enumerate(datasets):
            t = fe.submit(ds, seed=100 + i)
            direct.append(t.result(timeout=60).to_numpy())
        with ClusterServer(frontend=fe) as srv:
            with ClusterClient(*srv.address) as client:
                ids = [client.submit(ds, seed=100 + i)
                       for i, ds in enumerate(datasets)]
                wire = [client.result(rid, timeout=60) for rid in ids]
    for ref, got in zip(direct, wire):
        np.testing.assert_array_equal(ref.indices, got.indices)
        np.testing.assert_array_equal(ref.centers, got.centers)
        assert got.centers.dtype == ref.centers.dtype == np.float32
        assert float(ref.cost) == float(got.cost)
        assert got.extras["server"]["solve_seconds"] >= 0.0


@pytest.mark.timeout(LIMIT)
def test_streamed_upload_matches_inline():
    ds = _mixture(900, seed=7)
    with ClusterServer(SPEC, CPU, max_batch=2, max_wait_ms=2.0) as srv:
        with ClusterClient(*srv.address, stream_threshold_bytes=1024,
                           chunk_bytes=4096) as streamer, \
                ClusterClient(*srv.address) as inline:
            a = streamer.submit(ds, seed=5)
            b = inline.submit(ds, seed=5)
            ra = streamer.result(a, timeout=60)
            rb = inline.result(b, timeout=60)
    np.testing.assert_array_equal(ra.indices, rb.indices)
    np.testing.assert_array_equal(ra.centers, rb.centers)
    assert float(ra.cost) == float(rb.cost)


@pytest.mark.timeout(LIMIT)
def test_deadline_expiry_is_typed_over_the_wire():
    with ClusterServer(SPEC, CPU, max_batch=8, max_wait_ms=1.0) as srv:
        with ClusterClient(*srv.address) as client:
            rid = client.submit(_mixture(400, seed=3), seed=1,
                                deadline=1e-6)
            with pytest.raises(DeadlineExceededError):
                client.result(rid, timeout=60)
            st_ = client.stats(timeout=60)
    assert st_["deadline_expired"] >= 1 and st_["net"]["errors_sent"] >= 1


@pytest.mark.timeout(LIMIT)
def test_tenant_quota_throttles_hot_without_starving_cold():
    scheduler = TenantScheduler({
        "hot": TenantPolicy(rate_hz=0.001, burst=3.0, weight=1.0),
        "cold": TenantPolicy(weight=4.0),
    }, default=None)
    datasets = [_mixture(300, seed=50 + i) for i in range(6)]
    with ClusterServer(SPEC, CPU, max_batch=4, max_wait_ms=5.0,
                       admission=scheduler) as srv:
        with ClusterClient(*srv.address) as client:
            hot = [client.submit(ds, seed=i, tenant="hot")
                   for i, ds in enumerate(datasets)]
            cold = [client.submit(ds, seed=i, tenant="cold")
                    for i, ds in enumerate(datasets)]
            throttled = 0
            for rid in hot:
                try:
                    client.result(rid, timeout=60)
                except QuotaExceededError:
                    throttled += 1
            cold_results = [client.result(rid, timeout=60) for rid in cold]
            rogue = client.submit(datasets[0], seed=0, tenant="rogue")
            with pytest.raises(QuotaExceededError):
                client.result(rogue, timeout=60)
            st_ = client.stats(timeout=60)
    assert throttled == 3 and len(cold_results) == 6
    assert st_["tenants"]["cold"]["completed"] == 6
    assert st_["tenants"]["hot"]["throttled"] == 3
    assert st_["tenancy"]["hot"]["throttled"] == 3
    assert st_["tenancy"]["cold"]["dispatched"] == 6
    assert st_["tenancy"]["cold"]["virtual_time"] == pytest.approx(6 / 4.0)


def _first_frames(sock):
    reader, frames = FrameReader(), []
    while not frames:
        data = sock.recv(1 << 16)
        assert data, "server closed without a typed refusal"
        frames.extend(reader.feed(data))
    return frames


@pytest.mark.timeout(LIMIT)
def test_malformed_wire_input_gets_typed_refusal_and_clean_ledger():
    with ClusterServer(SPEC, CPU, max_batch=2, max_wait_ms=1.0) as srv:
        with socket.create_connection(srv.address, timeout=10) as sock:
            sock.sendall(struct.pack("<I", 0xFFFFFFF0) + b"junk")
            frames = _first_frames(sock)
            assert isinstance(frames[0], ErrorFrame)
            assert frames[0].code == WIRE_PROTOCOL_ERROR
            assert sock.recv(1 << 16) == b"", "connection not closed"
        with socket.create_connection(srv.address, timeout=10) as sock:
            sock.sendall(ResultFrame(
                1, indices=np.zeros(2, "<i8"),
                centers=np.zeros((2, 2), "<f8"), cost=0.0).encode())
            assert _first_frames(sock)[0].code == WIRE_PROTOCOL_ERROR
        st_ = srv.stats()
    assert st_["submitted"] == 0 and st_["net"]["requests_admitted"] == 0


@pytest.mark.timeout(LIMIT)
def test_mid_stream_disconnect_balances_ledger():
    datasets = [_mixture(300 + 40 * i, seed=70 + i) for i in range(3)]
    with ClusterFrontend(SPEC, CPU, max_batch=4, max_wait_ms=20.0) as fe:
        with ClusterServer(frontend=fe) as srv:
            client = ClusterClient(*srv.address, retries=0)
            for i, ds in enumerate(datasets):
                client.submit(ds, seed=i)
            big = SubmitFrame.from_points(99, datasets[0], seed=9,
                                          streamed=True)
            with client._wlock:
                client._sock.sendall(big.encode())
                client._sock.sendall(ChunkFrame(99, b"\x00" * 128).encode())
            client.close()
            t0 = time.monotonic()
            while fe.stats()["completed"] + fe.stats()["failed"] < 3:
                assert time.monotonic() - t0 < 60
                time.sleep(0.02)
        st_ = fe.stats()
    assert st_["submitted"] == 3
    assert st_["completed"] + st_["failed"] + st_["cancelled"] \
        == st_["submitted"]
    assert st_["held"] == 0 and st_["inflight"] == 0


@pytest.mark.timeout(LIMIT)
def test_duplicate_request_id_is_idempotent():
    ds = _mixture(300, seed=4)
    with ClusterServer(SPEC, CPU, max_batch=2, max_wait_ms=2.0) as srv:
        frame = SubmitFrame.from_points(7, ds, seed=11).encode()
        with socket.create_connection(srv.address, timeout=10) as sock:
            sock.sendall(frame + frame)
            reader = FrameReader()
            first = []
            while not first:
                first.extend(reader.feed(sock.recv(1 << 16)))
            second = []
            sock.settimeout(0.5)
            t0 = time.monotonic()
            while not second:
                assert time.monotonic() - t0 < 30
                sock.sendall(frame)
                try:
                    second.extend(reader.feed(sock.recv(1 << 16)))
                except TimeoutError:
                    continue
            sock.settimeout(10)
        t0 = time.monotonic()
        while srv.stats()["net"]["results_sent"] < 2:
            assert time.monotonic() - t0 < 30, srv.stats()["net"]
            time.sleep(0.01)
        st_ = srv.stats()
    assert isinstance(first[0], ResultFrame)
    assert isinstance(second[0], ResultFrame)
    np.testing.assert_array_equal(first[0].indices, second[0].indices)
    np.testing.assert_array_equal(first[0].centers, second[0].centers)
    assert first[0].cost == second[0].cost
    assert st_["net"]["duplicates_dropped"] >= 1
    assert st_["net"]["results_sent"] == 2


@pytest.mark.timeout(LIMIT)
def test_extend_over_the_wire_creates_then_grows_a_stream():
    spec = ClusterSpec(k=2, seeder="rejection", c=1.2, quantize=False,
                       seed=0, options={"lsh_r": 1e6, "resolution": 0.05})
    rng = np.random.default_rng(0)
    first, more = rng.normal(size=(24, 3)) * 3.0, rng.normal(size=(8, 3))
    with ClusterServer(spec, DEV, max_batch=2, max_wait_ms=2.0) as srv:
        with ClusterClient(*srv.address) as client:
            r0 = client.result(client.extend(first, stream="s"), timeout=60)
            r1 = client.result(client.extend(more, stream="s", seed=4),
                               timeout=60)
            r2 = client.result(client.extend(None, stream="s", seed=4),
                               timeout=60)
            missing = client.extend(None, stream="nope")
            with pytest.raises(Exception, match="does not exist"):
                client.result(missing, timeout=60)
            st_ = client.stats(timeout=60)
    assert (r0.extras["generation"], r1.extras["generation"],
            r2.extras["generation"]) == (0, 1, 1)
    np.testing.assert_array_equal(r1.indices, r2.indices)
    assert r1.indices.max() < 32
    assert st_["net"]["streams"] == 1 and st_["extends"] == 3

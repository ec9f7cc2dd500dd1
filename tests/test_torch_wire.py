"""The port's wire protocol (``keystone_tpu_torch.core.wire``) against
``keystone_tpu.core.wire`` on the CPU.

* Every encoder's bytes equal the reference's over a hypothesis sweep of
  dtypes and shapes (arrays, frames, ERROR, RETRY_AFTER, CLOCK, traced
  REQUEST, obs bodies), and each package decodes the other's frames.
* Partial frames: byte-by-byte extraction, two frames in one buffer,
  runt / oversized / bad-version frames typed.
* Across packages on localhost: the JAX ``WireClient`` against the port's
  ``WireServer`` and the port's ``WireClient`` against the JAX
  ``WireServer``, each serving the same seeded toy engines (the
  fusion-invariant ``max(x * w, b)``), answers ``np.array_equal``.
* The port's server: in-flight RETRY_AFTER, typed errors across the wire,
  slow loris, a client disconnecting mid-batch, the observability frames
  answered with the member's obs payload (``core.fleetobs``)."""

import os
import socket
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import test_frontend as jax_frontend_tests
import test_torch_frontend as port_frontend_tests
from keystone_tpu.core import frontend as jfrontend
from keystone_tpu.core import wire as jwire
from keystone_tpu_torch.core import frontend, wire
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core.resilience import counters

pytestmark = pytest.mark.serve

_DTYPES = [np.float32, np.float64, np.float16, np.int8, np.int16, np.int32, np.int64,
           np.uint8, np.uint16, np.bool_, np.complex64, ">f4", ">i8"]

_arrays = st.sampled_from(_DTYPES).flatmap(
    lambda dt: hnp.arrays(np.dtype(dt), hnp.array_shapes(min_dims=0, max_dims=4, min_side=0,
                                                          max_side=5))
)


# -- framing: the reference's bytes ----------------------------------------------------


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(arr=_arrays, rid=st.integers(0, 2**64 - 1))
def test_array_frames_byte_equal_to_the_reference(arr, rid):
    body = wire.encode_array(arr)
    assert body == jwire.encode_array(arr)
    frame = wire.encode_frame(wire.T_REQUEST, rid, body)
    assert frame == jwire.encode_frame(jwire.T_REQUEST, rid, body)
    assert wire.encode_traced_request(rid, rid // 3, arr) == jwire.encode_traced_request(
        rid, rid // 3, arr)
    for decode, encoded in ((wire.decode_array, jwire.encode_array(arr)),
                            (jwire.decode_array, body)):
        out = decode(encoded)
        assert out.dtype == arr.dtype and out.shape == arr.shape
        assert out.tobytes() == np.ascontiguousarray(arr).tobytes()


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(
    rid=st.integers(0, 2**64 - 1),
    etype=st.text(max_size=40),
    message=st.text(max_size=300),
    seconds=st.floats(allow_nan=False, width=64),
    t_client=st.floats(allow_nan=False, width=64),
    t_server=st.floats(allow_nan=False, width=64),
)
def test_control_frames_byte_equal_to_the_reference(rid, etype, message, seconds, t_client,
                                                    t_server):
    assert wire.encode_error(rid, etype, message) == jwire.encode_error(rid, etype, message)
    assert wire.encode_retry_after(rid, seconds, message) == jwire.encode_retry_after(
        rid, seconds, message)
    assert wire.encode_clock(rid, t_client) == jwire.encode_clock(rid, t_client)
    assert wire.encode_clock_reply(rid, t_client, t_server) == jwire.encode_clock_reply(
        rid, t_client, t_server)
    for ftype in (wire.T_PING, wire.T_PONG, wire.T_OBS_SNAPSHOT, wire.T_OBS_FLIGHT):
        assert wire.encode_frame(ftype, rid) == jwire.encode_frame(ftype, rid)
    obs = {"label": etype, "n": rid, "msg": message}
    assert wire.encode_obs(wire.T_OBS_SNAPSHOT, rid, obs) == jwire.encode_obs(
        jwire.T_OBS_SNAPSHOT, rid, obs)
    _, _, body = wire.extract_frame(bytearray(jwire.encode_error(rid, etype, message)), 2**30)
    et, msg = wire.decode_error(body)
    assert et == etype.encode("utf-8", "replace").decode("utf-8")
    _, _, body = wire.extract_frame(bytearray(jwire.encode_clock_reply(rid, t_client, t_server)),
                                    2**20)
    assert wire.decode_clock_reply(body) == (t_client, t_server)


def test_frame_constants_match_the_reference():
    for name in ("WIRE_VERSION", "T_REQUEST", "T_RESPONSE", "T_ERROR", "T_RETRY_AFTER",
                 "T_PING", "T_PONG", "T_CLOCK", "T_REQUEST_TRACED", "T_OBS_SNAPSHOT",
                 "T_OBS_FLIGHT", "DEFAULT_MAX_INFLIGHT", "DEFAULT_MAX_FRAME_MB", "PORT_ENV",
                 "MAX_INFLIGHT_ENV", "MAX_FRAME_MB_ENV"):
        assert getattr(wire, name) == getattr(jwire, name), name


def test_frame_extract_handles_partials_byte_by_byte():
    arr = np.arange(5, dtype=np.float32)
    frame = jwire.encode_frame(jwire.T_REQUEST, 77, jwire.encode_array(arr))
    buf = bytearray()
    out = None
    for byte in frame:
        buf.append(byte)
        got = wire.extract_frame(buf, wire.max_frame_bytes())
        if got is not None:
            out = got
    assert out is not None
    ftype, rid, body = out
    assert (ftype, rid) == (wire.T_REQUEST, 77)
    assert np.array_equal(wire.decode_array(body), arr)
    assert not buf
    buf = bytearray(wire.encode_frame(wire.T_PING, 1) + wire.encode_frame(wire.T_PING, 2))
    assert wire.extract_frame(buf, 2**20)[1] == 1
    assert wire.extract_frame(buf, 2**20)[1] == 2
    assert wire.extract_frame(buf, 2**20) is None


def test_bad_frames_are_typed():
    with pytest.raises(wire.WireProtocolError, match="cap"):
        wire.extract_frame(bytearray(wire._LEN.pack(2**30) + b"xxxx"), wire.max_frame_bytes())
    with pytest.raises(wire.WireProtocolError, match="runt"):
        wire.extract_frame(bytearray(wire._LEN.pack(2) + b"xx"), 2**20)
    payload = wire._HEAD.pack(9, wire.T_PING, 1)
    with pytest.raises(wire.WireProtocolError, match="version"):
        wire.extract_frame(bytearray(wire._LEN.pack(len(payload)) + payload), 2**20)
    with pytest.raises(wire.WireProtocolError, match="object"):
        wire.encode_array(np.array(["x"], dtype=object))
    body = wire.encode_array(np.zeros(4, np.float32))
    with pytest.raises(wire.WireProtocolError, match="declares"):
        wire.decode_array(body[:-2])


# -- across packages on localhost ---------------------------------------------------------


def _port_router():
    router = frontend.ShapeRouter(label="wire_port")
    for shape in ((16,), (8,)):
        router.add_engine(port_frontend_tests._make_engine(shape))
    return router


def _jax_router():
    router = jfrontend.ShapeRouter(label="wire_jax")
    for shape in ((16,), (8,)):
        router.add_engine(jax_frontend_tests._make_engine(shape))
    return router


@pytest.mark.parametrize("server_side,client_side", [("port", "jax"), ("jax", "port")])
def test_each_client_is_answered_by_the_other_server(server_side, client_side, rng):
    r16 = rng.normal(size=(12, 16)).astype(np.float32)
    r8 = rng.normal(size=(5, 8)).astype(np.float32)
    expect = {}
    with _port_router() as pr:
        expect[16] = pr.server_for((16,)).engine.offline(r16)
        expect[8] = pr.server_for((8,)).engine.offline(r8)
    router = _port_router() if server_side == "port" else _jax_router()
    server_mod = wire if server_side == "port" else jwire
    client_mod = jwire if client_side == "jax" else wire
    try:
        with server_mod.WireServer(router, port=0) as ws:
            with client_mod.WireClient(port=ws.port, timeout=30.0) as client:
                assert client.ping() < 5.0
                a16 = np.stack(client.predict_many(list(r16), window=4))
                a8 = np.stack(client.predict_many(list(r8), window=4))
                traced_rid = client.submit(r16[0], client_span=1234)
                reply = client.read()
                assert (reply.type, reply.request_id) == (wire.T_RESPONSE, traced_rid)
                assert np.array_equal(reply.value, expect[16][0])
                assert client.clock_sync(samples=2) is not None
            assert ws.record()["stats"]["protocol_errors"] == 0
    finally:
        router.close()
    assert np.array_equal(a16, expect[16])
    assert np.array_equal(a8, expect[8])


# -- the port's server ------------------------------------------------------------------


class _StallTarget:
    """Accepts every submit and resolves nothing until told."""

    def __init__(self):
        self.lock = threading.Lock()
        self.futs: list = []

    def submit(self, arr):
        fut = kserve.ServeFuture()
        with self.lock:
            self.futs.append((fut, np.asarray(arr)))
        return fut

    def release_all(self):
        with self.lock:
            futs, self.futs = self.futs, []
        for fut, arr in futs:
            fut._resolve(value=arr * 2.0)


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_inflight_window_pushes_back_retry_after():
    target = _StallTarget()
    with wire.WireServer(target, port=0, max_inflight=2) as ws:
        client = jwire.WireClient(port=ws.port, timeout=10.0)
        try:
            for _ in range(5):
                client.submit(np.zeros(4, np.float32))
            for _ in range(3):
                reply = client.read()
                assert reply.type == jwire.T_RETRY_AFTER and reply.retry_after_s > 0
            target.release_all()
            assert {client.read().request_id for _ in range(2)} == {1, 2}
        finally:
            client.close()
        assert ws.stats.retry_after == 3


def test_typed_errors_cross_the_wire(rng):
    with _port_router() as router:
        with wire.WireServer(router, port=0) as ws:
            with jwire.WireClient(port=ws.port) as client:
                with pytest.raises(jwire.WireRemoteError) as ei:
                    client.predict(np.zeros(5, np.float32))
                assert ei.value.etype == "NoRouteForShape"
                bad = rng.normal(size=16).astype(np.float32)
                bad[0] = np.nan
                with pytest.raises(jwire.WireRemoteError) as ei:
                    client.predict(bad)
                assert ei.value.etype == "MalformedRequest"
                ok = rng.normal(size=16).astype(np.float32)
                expect = router.server_for((16,)).engine.offline(ok[None])[0]
                assert np.array_equal(client.predict(ok), expect)
            assert ws.stats.errors >= 2


def test_router_backpressure_maps_to_retry_after(rng):
    cfg = frontend.RouterConfig(warm_threshold=2, retry_after_s=0.01)
    router = frontend.ShapeRouter(port_frontend_tests._make_engine, label="wirewarm", config=cfg)
    try:
        with wire.WireServer(router, port=0) as ws:
            with wire.WireClient(port=ws.port) as client:
                out = client.predict(rng.normal(size=8).astype(np.float32), timeout=60.0)
                assert out is not None
                assert ws.stats.retry_after >= 1
        assert router.stats.warm_adds == 1
    finally:
        router.close()


def test_slow_loris_partial_frame_starves_nobody():
    target = _StallTarget()
    with wire.WireServer(target, port=0) as ws:
        loris = socket.create_connection(("127.0.0.1", ws.port), 5.0)
        try:
            loris.sendall(b"\x00\x00")  # half a length prefix, then silence
            time.sleep(0.1)
            t0 = time.monotonic()
            with wire.WireClient(port=ws.port, timeout=10.0) as c:
                c.submit(np.ones(4, np.float32))
                assert _wait_for(lambda: target.futs)
                target.release_all()
                assert c.read().type == wire.T_RESPONSE
            assert time.monotonic() - t0 < 5.0
        finally:
            loris.close()


def test_client_disconnect_mid_batch_counted_batch_completes():
    target = _StallTarget()
    before = counters.get("wire_client_disconnect")
    with wire.WireServer(target, port=0, max_inflight=8) as ws:
        a = wire.WireClient(port=ws.port, timeout=10.0)
        for _ in range(3):
            a.submit(np.ones(4, np.float32))
        assert _wait_for(lambda: len(target.futs) == 3)
        a.close()
        assert _wait_for(lambda: ws.stats.mid_batch_disconnects == 1)
        assert counters.get("wire_client_disconnect") == before + 1
        target.release_all()
        with wire.WireClient(port=ws.port, timeout=10.0) as b:
            b.submit(np.full(4, 3.0, np.float32))
            assert _wait_for(lambda: target.futs)
            target.release_all()
            reply = b.read()
            assert reply.type == wire.T_RESPONSE
            assert np.array_equal(reply.value, np.full(4, 6.0, np.float32))


@pytest.mark.parametrize("client_mod", [wire, jwire])
def test_observability_frames_answer_error(client_mod):
    """Both observability frames answer the member's payload, not an ERROR
    frame, to either package's client; the connection survives and no
    protocol error is counted."""
    target = _StallTarget()
    with wire.WireServer(target, port=0) as ws:
        with client_mod.WireClient(port=ws.port, timeout=10.0) as c:
            snap = c.obs_snapshot()
            flight = c.obs_flight()
            for payload in (snap, flight):
                assert payload["schema"] == "keystone.obs/1"
                assert payload["pid"] == os.getpid() and payload["now_us"] > 0
            assert "statusz" in snap and isinstance(flight["flight"], list)
            assert c.ping() < 5.0  # the connection survives
        assert ws.stats.protocol_errors == 0


def test_protocol_violation_answers_error_and_closes():
    target = _StallTarget()
    with wire.WireServer(target, port=0) as ws:
        sock = socket.create_connection(("127.0.0.1", ws.port), 5.0)
        try:
            sock.sendall(wire._LEN.pack(2**31) + b"garbage")
            sock.settimeout(5.0)
            buf = bytearray()
            while (frame := wire.extract_frame(buf, 2**20)) is None:
                chunk = sock.recv(4096)
                assert chunk, "connection closed with no ERROR frame"
                buf.extend(chunk)
            assert frame[0] == wire.T_ERROR
            assert wire.decode_error(frame[2])[0] == "WireProtocolError"
            assert _wait_for(lambda: not sock.recv(4096), timeout=5.0)
        finally:
            sock.close()
        assert ws.stats.protocol_errors == 1


def test_close_is_idempotent_and_joins():
    ws = wire.WireServer(_StallTarget(), port=0)
    with wire.WireClient(port=ws.port) as c:
        c.ping()
        ws.close()
        ws.close()
    assert not ws._accept_thread.is_alive()

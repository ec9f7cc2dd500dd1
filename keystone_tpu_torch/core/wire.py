"""Socket wire protocol for the serving front-end (counterpart of
keystone_tpu/core/wire.py): length-prefixed numpy-native framing, a
threaded accept loop, per-client in-flight windows, and explicit
backpressure.

The frames are the JAX package's byte for byte, so its ``WireClient`` and
``tools/serve_client.py`` talk to this ``WireServer`` and this
``WireClient`` to its server.

**Frame layout** (everything big-endian, no external serializer — numpy's
own dtype strings and raw C-order bytes are the only encoding):

.. code-block:: text

    frame    := u32 payload_len | payload          (payload_len <= max frame)
    payload  := u8 version (=1) | u8 type | u64 request_id | body
    type     := 1 REQUEST | 2 RESPONSE | 3 ERROR | 4 RETRY_AFTER
                | 5 PING | 6 PONG | 7 CLOCK | 8 REQUEST_TRACED
                | 9 OBS_SNAPSHOT | 10 OBS_FLIGHT
    array    := u8 ndim | u16 dtype_len | dtype_str (numpy .str, e.g "<f4")
                | ndim * u32 dim | raw C-order bytes       (REQUEST/RESPONSE)
    error    := u16 etype_len | etype utf-8 | u32 msg_len | msg utf-8
    retry    := f64 retry_after_s | u32 msg_len | msg utf-8

**Server** (:class:`WireServer`) — a threaded accept loop
(``KEYSTONE_WIRE_PORT``; ``0`` binds an ephemeral port) with one reader and
one responder thread per connection, so a slow-loris client parks only
its own reader.  Every connection gets a bounded in-flight window
(``KEYSTONE_WIRE_MAX_INFLIGHT``): requests beyond it answer RETRY_AFTER.
A :class:`~.frontend.RetryLater` from the router maps onto RETRY_AFTER
with its hint; ``MalformedRequest`` / ``NoRouteForShape`` /
``ServingUnavailable`` onto ERROR frames carrying the error type.  A
client that disconnects with requests in flight is counted
``wire_client_disconnect``; its requests still complete and the answers
are discarded.  The observability frames (9, 10) answer with
``core.fleetobs.agent_payload`` (every wire server doubles as its
process's obs agent); a payload that fails to build answers a typed ERROR
frame and never touches the serving path.

**Client** (:class:`WireClient`) — ``predict``/``predict_many`` honour
RETRY_AFTER (sleep the hint, resubmit), surface ERROR frames as typed
:class:`WireRemoteError`, and pipeline a bounded window of requests;
``ping``, ``clock_sync`` and traced requests as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import struct
import threading
import time
from collections import deque

import numpy as np

from . import trace
from .resilience import counters
from .serve_errors import RetryLater, ServeError, ServingUnavailable, _env_pos_int

_logger = logging.getLogger("keystone_tpu_torch.wire")

PORT_ENV = "KEYSTONE_WIRE_PORT"
MAX_INFLIGHT_ENV = "KEYSTONE_WIRE_MAX_INFLIGHT"
MAX_FRAME_MB_ENV = "KEYSTONE_WIRE_MAX_FRAME_MB"

WIRE_VERSION = 1

T_REQUEST = 1
T_RESPONSE = 2
T_ERROR = 3
T_RETRY_AFTER = 4
T_PING = 5
T_PONG = 6
#: clock-offset handshake (cross-process trace stitching): the client
#: sends its trace clock (``trace.now_us``), the server echoes it with its
#: OWN trace clock appended — offset = server - (client + rtt/2).
T_CLOCK = 7
#: REQUEST with a trace-context prefix (u64 client span id before the
#: array body): the server's ``wire.request`` instant records the
#: client-side span the request rode in, so ``trace_view --stitch`` can
#: join the two processes' timelines by more than the rid alone.
T_REQUEST_TRACED = 8
#: Fleet observability (core.fleetobs): the collector asks a
#: member for its process-local observability surface.  The reply echoes
#: the frame type with a JSON body (utf-8) — the member's registry
#: snapshot + statusz + raw histogram sample windows (T_OBS_SNAPSHOT) or
#: its flight-recorder ring (T_OBS_FLIGHT), each stamped with the
#: member's ``trace.now_us`` so the collector can clock-align it via the
#: T_CLOCK offset handshake.  Old servers answer the unknown type with an
#: ERROR frame — a collector scraping a pre-obs member degrades, it does
#: not die.
T_OBS_SNAPSHOT = 9
T_OBS_FLIGHT = 10

_LEN = struct.Struct("!I")
_HEAD = struct.Struct("!BBQ")  # version, type, request_id
_NDIM = struct.Struct("!B")
_U16 = struct.Struct("!H")
_DIM = struct.Struct("!I")
_RETRY = struct.Struct("!d")
_CLOCK = struct.Struct("!d")  # one trace-clock sample (us)
_CLOCK2 = struct.Struct("!dd")  # client clock echoed + server clock
_SPAN = struct.Struct("!Q")  # trace-context prefix: client span id

DEFAULT_MAX_INFLIGHT = 32
DEFAULT_MAX_FRAME_MB = 64

#: Blocking waits poll at this period so stop flags are always observed
#: (the ingest/serve discipline, applied to sockets).
_POLL_SECONDS = 0.05


class WireError(ServeError):
    """Base of the wire tier's typed failures."""


class WireProtocolError(WireError):
    """A frame that violates the protocol: bad version, runt/oversized
    frame, or an array body whose declared shape/dtype does not match its
    bytes.  The server answers an ERROR frame and closes the connection —
    a protocol violator cannot be trusted with a parser state machine."""


class WireRemoteError(WireError):
    """Client-side surface of a server ERROR frame: carries the remote
    typed error's name so the in-process taxonomy survives the wire."""

    def __init__(self, etype: str, message: str):
        super().__init__(f"{etype}: {message}")
        self.etype = etype
        self.remote_message = message


def max_frame_bytes() -> int:
    return _env_pos_int(MAX_FRAME_MB_ENV, DEFAULT_MAX_FRAME_MB) * 2**20


# -- framing ------------------------------------------------------------------


def encode_array(arr: np.ndarray) -> bytes:
    """numpy-native array body: dtype string + dims + raw C-order bytes."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        # (ascontiguousarray would also promote rank-0 to rank-1 — only
        # touch layouts that actually need the copy)
        arr = np.ascontiguousarray(arr)
    if arr.dtype.hasobject:
        raise WireProtocolError(
            f"dtype {arr.dtype} is not wire-encodable (object arrays have "
            "no defined byte layout)"
        )
    if arr.ndim > 255:
        raise WireProtocolError(f"rank {arr.ndim} exceeds the u8 ndim field")
    dt = arr.dtype.str.encode("ascii")
    parts = [_NDIM.pack(arr.ndim), _U16.pack(len(dt)), dt]
    parts.extend(_DIM.pack(int(d)) for d in arr.shape)
    parts.append(arr.tobytes())
    return b"".join(parts)


def decode_array(body) -> np.ndarray:
    """Inverse of :func:`encode_array`; every declared size is validated
    against the actual bytes before numpy touches them."""
    body = memoryview(body)
    try:
        (ndim,) = _NDIM.unpack_from(body, 0)
        (dt_len,) = _U16.unpack_from(body, 1)
        off = 3 + dt_len
        dt_str = bytes(body[3:off]).decode("ascii")
        dims = []
        for _ in range(ndim):
            (d,) = _DIM.unpack_from(body, off)
            dims.append(int(d))
            off += _DIM.size
    except (struct.error, UnicodeDecodeError) as e:
        raise WireProtocolError(f"truncated array header: {e}") from None
    try:
        dtype = np.dtype(dt_str)
    except TypeError as e:
        raise WireProtocolError(f"bad dtype string {dt_str!r}: {e}") from None
    if dtype.hasobject:
        raise WireProtocolError(f"dtype {dt_str!r} is not wire-decodable")
    expected = int(np.prod(dims, dtype=np.int64)) * dtype.itemsize if dims \
        else dtype.itemsize
    if len(body) - off != expected:
        raise WireProtocolError(
            f"array body holds {len(body) - off} bytes but shape "
            f"{tuple(dims)} dtype {dt_str} declares {expected}"
        )
    arr = np.frombuffer(body[off:], dtype=dtype)
    return arr.reshape(dims) if dims else arr.reshape(())


def _encode_str(s: str, width: struct.Struct) -> bytes:
    raw = s.encode("utf-8", errors="replace")
    return width.pack(len(raw)) + raw


def encode_frame(ftype: int, rid: int, body: bytes = b"") -> bytes:
    payload = _HEAD.pack(WIRE_VERSION, ftype, rid) + body
    return _LEN.pack(len(payload)) + payload


def encode_error(rid: int, etype: str, message: str) -> bytes:
    body = _encode_str(etype, _U16) + _encode_str(message[:2000], _LEN)
    return encode_frame(T_ERROR, rid, body)


def encode_retry_after(rid: int, seconds: float, message: str = "") -> bytes:
    body = _RETRY.pack(float(seconds)) + _encode_str(message[:2000], _LEN)
    return encode_frame(T_RETRY_AFTER, rid, body)


def decode_error(body) -> tuple[str, str]:
    body = memoryview(body)
    try:
        (et_len,) = _U16.unpack_from(body, 0)
        etype = bytes(body[2 : 2 + et_len]).decode("utf-8")
        (msg_len,) = _LEN.unpack_from(body, 2 + et_len)
        off = 2 + et_len + _LEN.size
        msg = bytes(body[off : off + msg_len]).decode("utf-8")
    except (struct.error, UnicodeDecodeError) as e:
        raise WireProtocolError(f"truncated error body: {e}") from None
    return etype, msg


def encode_clock(rid: int, t_client_us: float) -> bytes:
    """Client -> server clock-sync probe carrying the client trace clock."""
    return encode_frame(T_CLOCK, rid, _CLOCK.pack(float(t_client_us)))


def encode_clock_reply(
    rid: int, t_client_us: float, t_server_us: float
) -> bytes:
    """Server -> client clock-sync echo: the probe's clock + the server's."""
    return encode_frame(
        T_CLOCK, rid, _CLOCK2.pack(float(t_client_us), float(t_server_us))
    )


def decode_clock(body) -> float:
    try:
        (t,) = _CLOCK.unpack_from(memoryview(body), 0)
    except struct.error as e:
        raise WireProtocolError(f"truncated clock body: {e}") from None
    return t


def decode_clock_reply(body) -> tuple[float, float]:
    try:
        tc, ts = _CLOCK2.unpack_from(memoryview(body), 0)
    except struct.error as e:
        raise WireProtocolError(f"truncated clock reply: {e}") from None
    return tc, ts


def encode_traced_request(rid: int, client_span: int, arr) -> bytes:
    """REQUEST with the optional trace-context field: the client's span id
    rides ahead of the array body (old servers answer an ERROR frame for
    the unknown type — a traced client degrades to plain REQUESTs)."""
    return encode_frame(
        T_REQUEST_TRACED,
        rid,
        _SPAN.pack(int(client_span)) + encode_array(np.asarray(arr)),
    )


def split_trace_context(body) -> tuple[int, memoryview]:
    """``(client_span, array_body)`` of a T_REQUEST_TRACED payload."""
    body = memoryview(body)
    try:
        (span,) = _SPAN.unpack_from(body, 0)
    except struct.error as e:
        raise WireProtocolError(f"truncated trace context: {e}") from None
    return int(span), body[_SPAN.size:]


def encode_obs(ftype: int, rid: int, payload: dict) -> bytes:
    """Observability frame: ``payload`` as a JSON utf-8 body (the obs
    surface is nested/stringly — numpy framing buys nothing here)."""
    import json

    return encode_frame(
        ftype, rid, json.dumps(payload, separators=(",", ":")).encode("utf-8")
    )


def decode_obs(body) -> dict:
    import json

    try:
        doc = json.loads(bytes(memoryview(body)).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise WireProtocolError(f"bad obs body: {e}") from None
    if not isinstance(doc, dict):
        raise WireProtocolError(
            f"obs body is {type(doc).__name__}, expected an object"
        )
    return doc


def decode_retry_after(body) -> tuple[float, str]:
    body = memoryview(body)
    try:
        (seconds,) = _RETRY.unpack_from(body, 0)
        (msg_len,) = _LEN.unpack_from(body, _RETRY.size)
        off = _RETRY.size + _LEN.size
        msg = bytes(body[off : off + msg_len]).decode("utf-8")
    except (struct.error, UnicodeDecodeError) as e:
        raise WireProtocolError(f"truncated retry body: {e}") from None
    return seconds, msg


def extract_frame(buf: bytearray, max_bytes: int):
    """Pop one complete frame off ``buf`` (in place).  Returns
    ``(type, request_id, body_memoryview)`` or None when the buffer holds
    only a partial frame — the caller keeps reading.  Raises
    :class:`WireProtocolError` on a frame that can never become valid."""
    if len(buf) < _LEN.size:
        return None
    (plen,) = _LEN.unpack_from(buf, 0)
    if plen < _HEAD.size:
        raise WireProtocolError(f"runt frame ({plen} payload bytes)")
    if plen > max_bytes:
        raise WireProtocolError(
            f"frame of {plen} bytes exceeds the {max_bytes}-byte cap "
            f"({MAX_FRAME_MB_ENV})"
        )
    if len(buf) < _LEN.size + plen:
        return None
    payload = bytes(buf[_LEN.size : _LEN.size + plen])
    del buf[: _LEN.size + plen]
    version, ftype, rid = _HEAD.unpack_from(payload, 0)
    if version != WIRE_VERSION:
        raise WireProtocolError(
            f"wire version {version} != {WIRE_VERSION}"
        )
    return ftype, rid, memoryview(payload)[_HEAD.size :]


# -- the server ---------------------------------------------------------------


@dataclasses.dataclass
class WireStats:
    """Counters of one wire server's lifetime (bench/chaos artifact)."""

    connections: int = 0
    disconnects: int = 0  #: clean closes (no in-flight work at EOF)
    mid_batch_disconnects: int = 0  #: EOF with requests still in flight
    requests: int = 0
    responses: int = 0
    errors: int = 0  #: ERROR frames sent (typed failures crossed the wire)
    retry_after: int = 0  #: RETRY_AFTER frames sent (backpressure)
    protocol_errors: int = 0
    bytes_in: int = 0
    bytes_out: int = 0

    def record(self) -> dict:
        return dataclasses.asdict(self)


class _Conn:
    """One live client connection: its socket, its bounded in-flight
    window, and the FIFO of futures its responder thread answers."""

    __slots__ = (
        "cid", "sock", "addr", "open", "reader_done", "inflight", "queue",
        "cond", "wlock", "reader", "responder",
    )

    def __init__(self, cid: int, sock: socket.socket, addr):
        self.cid = cid
        self.sock = sock
        self.addr = addr
        self.open = True
        self.reader_done = False
        self.inflight = 0
        self.queue: deque = deque()  # (wire_rid, future, t_received)
        self.cond = threading.Condition()
        self.wlock = threading.Lock()
        self.reader: threading.Thread | None = None
        self.responder: threading.Thread | None = None


class WireServer:
    """Serve a :class:`~.frontend.ShapeRouter` (or a bare
    :class:`~.serve.Server` — anything with a typed ``submit``) over a
    listening socket.  Constructing binds and starts accepting; use as a
    context manager or call :meth:`close`.

    ``port=None`` reads ``KEYSTONE_WIRE_PORT`` (``0``/unset = ephemeral;
    the bound port is ``self.port``).  ``max_inflight`` is the per-client
    fairness window (``KEYSTONE_WIRE_MAX_INFLIGHT``)."""

    def __init__(
        self,
        target,
        host: str = "127.0.0.1",
        port: int | None = None,
        *,
        max_inflight: int | None = None,
        request_timeout_s: float = 60.0,
        retry_after_s: float = 0.05,
        label: str = "wire",
    ):
        if port is None:
            raw = os.environ.get(PORT_ENV, "").strip()
            port = int(raw) if raw else 0
        self.target = target
        self.label = label
        self.max_inflight = (
            max_inflight
            if max_inflight is not None
            else _env_pos_int(MAX_INFLIGHT_ENV, DEFAULT_MAX_INFLIGHT)
        )
        self.request_timeout_s = float(request_timeout_s)
        self.retry_after_s = float(retry_after_s)
        self._max_frame = max_frame_bytes()
        self.stats = WireStats()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._conns: dict[int, _Conn] = {}
        self._next_cid = 0
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(64)
        self._listener.settimeout(_POLL_SECONDS)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="keystone-wire-accept", daemon=True
        )
        self._accept_thread.start()
        _logger.info(
            "wire server %s listening on %s:%d (max_inflight %d/client)",
            label, self.host, self.port, self.max_inflight,
        )

    # -- accept loop ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us — shutdown
            sock.settimeout(_POLL_SECONDS)
            with self._lock:
                self._next_cid += 1
                conn = _Conn(self._next_cid, sock, addr)
                self._conns[conn.cid] = conn
                self.stats.connections += 1
                active = len(self._conns)
            trace.metrics.inc("wire_connections")
            trace.metrics.gauge("wire_active_connections", active)
            conn.reader = threading.Thread(
                target=self._reader_loop, args=(conn,),
                name=f"keystone-wire-reader-{conn.cid}", daemon=True,
            )
            conn.responder = threading.Thread(
                target=self._responder_loop, args=(conn,),
                name=f"keystone-wire-responder-{conn.cid}", daemon=True,
            )
            conn.reader.start()
            conn.responder.start()

    # -- per-connection reader ------------------------------------------------

    def _reader_loop(self, conn: _Conn) -> None:
        buf = bytearray()
        eof = False
        try:
            while conn.open and not self._stop.is_set():
                try:
                    frame = extract_frame(buf, self._max_frame)
                except WireProtocolError as e:
                    with self._lock:
                        self.stats.protocol_errors += 1
                    trace.metrics.inc("wire_protocol_errors")
                    self._send(conn, encode_error(
                        0, "WireProtocolError", str(e)
                    ))
                    break  # a protocol violator loses its connection
                if frame is not None:
                    self._dispatch(conn, *frame)
                    continue
                try:
                    chunk = conn.sock.recv(65536)
                except socket.timeout:
                    continue  # poll: re-check stop flags
                except (ConnectionError, OSError):
                    eof = True
                    break
                if not chunk:
                    eof = True
                    break
                with self._lock:
                    self.stats.bytes_in += len(chunk)
                buf.extend(chunk)
        finally:
            with conn.cond:
                conn.reader_done = True
                pending = conn.inflight > 0 or bool(conn.queue)
                conn.cond.notify_all()
            if self._stop.is_set():
                pass  # server shutdown, not a client behavior — no verdict
            elif eof and pending:
                # Mid-batch disconnect: the batcher still completes the
                # micro-batches these requests ride in (batchmates are
                # never poisoned); the responder discards the unsendable
                # answers.  Counted — an operator-visible fault.
                with self._lock:
                    self.stats.mid_batch_disconnects += 1
                counters.record(
                    "wire_client_disconnect",
                    f"wire:{self.label}: client {conn.addr} disconnected "
                    "with requests in flight — batch completes, answers "
                    "discarded",
                )
            elif eof:
                with self._lock:
                    self.stats.disconnects += 1

    def _dispatch(self, conn: _Conn, ftype: int, rid: int, body) -> None:
        if ftype == T_PING:
            self._send(conn, encode_frame(T_PONG, rid))
            return
        if ftype == T_CLOCK:
            # Clock-offset handshake (cross-process stitching): echo the
            # client's trace clock with ours appended — the client
            # estimates offset = server - (client + rtt/2) and records it
            # in its own trace so --stitch can align the two timelines.
            try:
                t_client = decode_clock(body)
            except WireProtocolError as e:
                self._send(conn, encode_error(rid, "WireProtocolError", str(e)))
                return
            self._send(
                conn, encode_clock_reply(rid, t_client, trace.now_us())
            )
            return
        if ftype in (T_OBS_SNAPSHOT, T_OBS_FLIGHT):
            # Fleet observability scrape (core.fleetobs): EVERY wire
            # server doubles as its process's obs agent — the collector
            # reuses the serving port it already knows.  A failing
            # payload build answers a typed ERROR frame; the serving
            # path is never touched.
            try:
                from . import fleetobs

                payload = fleetobs.agent_payload(
                    "flight" if ftype == T_OBS_FLIGHT else "snapshot"
                )
                self._send(conn, encode_obs(ftype, rid, payload))
            except Exception as e:  # noqa: BLE001 — typed delivery
                self._send(conn, encode_error(rid, type(e).__name__, str(e)))
            return
        if ftype not in (T_REQUEST, T_REQUEST_TRACED):
            with self._lock:
                self.stats.protocol_errors += 1
            self._send(conn, encode_error(
                rid, "WireProtocolError",
                f"unexpected client frame type {ftype}",
            ))
            return
        t0 = time.perf_counter()
        with self._lock:
            self.stats.requests += 1
        trace.metrics.inc("wire_requests")
        client_span = None
        try:
            if ftype == T_REQUEST_TRACED:
                client_span, body = split_trace_context(body)
            arr = decode_array(body)
        except WireProtocolError as e:
            with self._lock:
                self.stats.errors += 1
            self._send(conn, encode_error(rid, "WireProtocolError", str(e)))
            return
        # Per-client fairness window: beyond it the client is pushed back
        # with RETRY_AFTER, never queued unboundedly — a flooder cannot
        # starve other connections out of the batcher.
        with conn.cond:
            if conn.inflight >= self.max_inflight:
                window_full = True
            else:
                window_full = False
                conn.inflight += 1
        if window_full:
            with self._lock:
                self.stats.retry_after += 1
            trace.metrics.inc("wire_retry_after")
            self._send(conn, encode_retry_after(
                rid, self.retry_after_s,
                f"in-flight window ({self.max_inflight}) full",
            ))
            return
        try:
            fut = self.target.submit(arr)
        except RetryLater as e:
            self._release(conn)
            with self._lock:
                self.stats.retry_after += 1
            trace.metrics.inc("wire_retry_after")
            self._send(conn, encode_retry_after(rid, e.retry_after_s, str(e)))
            return
        except Exception as e:  # noqa: BLE001 — typed delivery, never a hang
            # MalformedRequest / NoRouteForShape / ServingUnavailable and
            # any unexpected failure all cross the wire the same way: an
            # ERROR frame named after the exception type.
            self._release(conn)
            with self._lock:
                self.stats.errors += 1
            trace.metrics.inc("wire_errors")
            self._send(conn, encode_error(rid, type(e).__name__, str(e)))
            return
        # The wire id <-> serve id tie: every serve.* span of this request
        # correlates back to the connection that carried it (and, for a
        # traced client, to the CLIENT-side span it rode in).
        trace.instant(
            "wire.request", conn=conn.cid, wire_rid=rid,
            request_id=getattr(fut, "request_id", 0),
            **({"client_span": client_span} if client_span is not None else {}),
        )
        with conn.cond:
            conn.queue.append((rid, fut, t0))
            conn.cond.notify_all()

    def _release(self, conn: _Conn) -> None:
        with conn.cond:
            conn.inflight -= 1
            conn.cond.notify_all()

    # -- per-connection responder ---------------------------------------------

    def _responder_loop(self, conn: _Conn) -> None:
        try:
            self._respond_until_done(conn)
        finally:
            # The responder is the LAST writer on this connection: once it
            # returns (reader finished AND the answer queue drained) the
            # socket can be torn down — a protocol violator or EOF'd client
            # is actually disconnected, not parked until server close.
            self._drop_conn(conn)

    def _respond_until_done(self, conn: _Conn) -> None:
        while True:
            with conn.cond:
                while not conn.queue:
                    if conn.reader_done or self._stop.is_set():
                        return
                    conn.cond.wait(_POLL_SECONDS)
                rid, fut, t0 = conn.queue.popleft()
            try:
                value = self._await(fut)
            except BaseException as e:  # noqa: BLE001 — typed over the wire
                with self._lock:
                    self.stats.errors += 1
                trace.metrics.inc("wire_errors")
                self._send(conn, encode_error(
                    rid, type(e).__name__, str(e)
                ))
            else:
                ms = (time.perf_counter() - t0) * 1e3
                sent = self._send(
                    conn, encode_frame(T_RESPONSE, rid, encode_array(value))
                )
                if sent:
                    with self._lock:
                        self.stats.responses += 1
                    trace.metrics.inc("wire_responses")
                    trace.metrics.observe("wire_request_ms", ms)
                    trace.instant(
                        "wire.response", conn=conn.cid, wire_rid=rid,
                        ms=round(ms, 3),
                    )
            finally:
                self._release(conn)

    def _await(self, fut):
        """Wait out one future with the stop flag observed (a server
        shutting down must not leave a responder parked on a future the
        closing batcher is about to fail typed anyway)."""
        end = time.monotonic() + self.request_timeout_s
        while True:
            try:
                return fut.result(_POLL_SECONDS)
            except TimeoutError:
                if self._stop.is_set():
                    raise ServingUnavailable(
                        "wire server closing"
                    ) from None
                if time.monotonic() >= end:
                    raise TimeoutError(
                        f"request unanswered after {self.request_timeout_s}s"
                    ) from None

    # -- sends ----------------------------------------------------------------

    def _send(self, conn: _Conn, data: bytes, timeout_s: float = 30.0) -> bool:
        """Write one frame with the socket's short poll timeout survived:
        the 50ms settimeout that keeps recv responsive also governs send,
        and a client that merely PAUSES reading (full TCP receive buffer —
        e.g. one sleeping out a RETRY_AFTER hint) must get backpressure,
        not a dropped connection.  ``send`` (unlike ``sendall``) reports
        progress, so a timeout between partial writes is retryable without
        corrupting the frame stream; only a dead peer or the overall
        ``timeout_s`` budget closes the connection."""
        view = memoryview(data)
        off = 0
        end = time.monotonic() + timeout_s
        with conn.wlock:
            if not conn.open:
                return False
            while off < len(view):
                try:
                    off += conn.sock.send(view[off:])
                except socket.timeout:
                    if (
                        self._stop.is_set()
                        or not conn.open
                        or time.monotonic() >= end
                    ):
                        conn.open = False
                        return False
                    continue  # poll: the peer is slow, not gone
                except (ConnectionError, OSError):
                    conn.open = False
                    return False
        with self._lock:
            self.stats.bytes_out += len(data)
        return True

    # -- lifecycle ------------------------------------------------------------

    def _drop_conn(self, conn: _Conn) -> None:
        with self._lock:
            known = self._conns.pop(conn.cid, None) is not None
            active = len(self._conns)
        with conn.wlock:
            conn.open = False
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.sock.close()
            except OSError:  # pragma: no cover
                pass
        if known:
            trace.metrics.gauge("wire_active_connections", active)

    def close(self) -> None:
        """Stop accepting, close every connection, join the threads.
        Idempotent.  The serving target is NOT closed — it outlives its
        wire front-ends."""
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self._listener.close()
        except OSError:  # pragma: no cover
            pass
        self._accept_thread.join(5.0)
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            with conn.wlock:
                conn.open = False
                try:
                    conn.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.sock.close()
                except OSError:  # pragma: no cover
                    pass
            with conn.cond:
                conn.cond.notify_all()
        for conn in conns:
            for t in (conn.reader, conn.responder):
                if t is not None:
                    t.join(5.0)
        trace.metrics.gauge("wire_active_connections", 0)

    def __enter__(self) -> "WireServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def record(self) -> dict:
        with self._lock:
            active = len(self._conns)
            stats = self.stats.record()
        return {
            "label": self.label,
            "host": self.host,
            "port": self.port,
            "max_inflight": self.max_inflight,
            "active_connections": active,
            "stats": stats,
        }


# -- the reference client -----------------------------------------------------


@dataclasses.dataclass
class WireReply:
    """One decoded server frame."""

    type: int
    request_id: int
    value: np.ndarray | None = None
    etype: str | None = None
    message: str | None = None
    retry_after_s: float | None = None
    #: T_CLOCK reply: (client trace clock echoed, server trace clock) us
    clock: tuple | None = None
    #: T_OBS_* reply: the member's JSON observability payload
    obs: dict | None = None


class WireClient:
    """Blocking reference client for the wire protocol (one socket, used
    from one thread).  ``predict``/``predict_many`` honor RETRY_AFTER
    backpressure (sleep the hint, resubmit) and surface ERROR frames as
    typed :class:`WireRemoteError`."""

    def __init__(
        self, host: str = "127.0.0.1", port: int | None = None,
        timeout: float = 30.0,
    ):
        if port is None:
            raw = os.environ.get(PORT_ENV, "").strip()
            if not raw:
                raise ValueError(
                    f"no port given and {PORT_ENV} is unset"
                )
            port = int(raw)
        self._sock = socket.create_connection((host, int(port)), timeout)
        self._sock.settimeout(timeout)
        self.timeout = timeout
        self._max_frame = max_frame_bytes()
        self._buf = bytearray()
        self._next_id = 0

    def submit(self, arr, client_span: int | None = None) -> int:
        """Send one REQUEST frame; returns its wire request id.
        ``client_span`` rides as the optional trace-context field
        (T_REQUEST_TRACED) so the server's ``wire.request`` instant names
        the client-side span this request belongs to."""
        self._next_id += 1
        rid = self._next_id
        if client_span is not None:
            self._sock.sendall(encode_traced_request(rid, client_span, arr))
        else:
            self._sock.sendall(
                encode_frame(T_REQUEST, rid, encode_array(np.asarray(arr)))
            )
        return rid

    def clock_sync(self, samples: int = 5) -> dict | None:
        """Estimate the server-trace-clock offset: ``samples`` T_CLOCK
        round trips, keeping the minimum-RTT one (the least queue-skewed
        estimate).  Returns ``{"offset_us", "rtt_us"}`` — add ``offset_us``
        to a client trace timestamp to land on the server's timeline — or
        None when the server predates the handshake (it answers the
        unknown frame type with an ERROR; the client degrades, it does
        not die)."""
        from . import trace as ktrace

        best = None
        for _ in range(max(1, samples)):
            self._next_id += 1
            rid = self._next_id
            t0 = ktrace.now_us()
            self._sock.sendall(encode_clock(rid, t0))
            reply = self.read()
            t1 = ktrace.now_us()
            if reply.type == T_ERROR:
                return None  # pre-handshake server — degrade quietly
            if reply.type != T_CLOCK or reply.request_id != rid:
                raise WireProtocolError(
                    f"expected CLOCK {rid}, got type {reply.type} "
                    f"id {reply.request_id}"
                )
            t_client, t_server = reply.clock
            rtt = t1 - t_client
            offset = t_server - (t_client + rtt / 2.0)
            if best is None or rtt < best["rtt_us"]:
                best = {
                    "offset_us": round(offset, 1), "rtt_us": round(rtt, 1)
                }
        return best

    def _obs(self, ftype: int) -> dict | None:
        """One observability round trip; None when the server predates
        the obs frames (it answers ERROR — the collector degrades)."""
        self._next_id += 1
        rid = self._next_id
        self._sock.sendall(encode_frame(ftype, rid))
        reply = self.read()
        if reply.type == T_ERROR:
            return None
        if reply.type != ftype or reply.request_id != rid:
            raise WireProtocolError(
                f"expected OBS {ftype} id {rid}, got type {reply.type} "
                f"id {reply.request_id}"
            )
        return reply.obs

    def obs_snapshot(self) -> dict | None:
        """The member's observability snapshot: statusz + registry
        snapshot + raw histogram sample windows, stamped with its
        ``trace.now_us`` (core.fleetobs scrapes through this)."""
        return self._obs(T_OBS_SNAPSHOT)

    def obs_flight(self) -> dict | None:
        """The member's flight-recorder ring (incident capture)."""
        return self._obs(T_OBS_FLIGHT)

    def ping(self) -> float:
        """Round-trip one PING; returns seconds."""
        t0 = time.perf_counter()
        self._next_id += 1
        self._sock.sendall(encode_frame(T_PING, self._next_id))
        reply = self.read()
        if reply.type != T_PONG or reply.request_id != self._next_id:
            raise WireProtocolError(
                f"expected PONG {self._next_id}, got type {reply.type} "
                f"id {reply.request_id}"
            )
        return time.perf_counter() - t0

    def read(self) -> WireReply:
        """Block for the next server frame (socket timeout raises
        ``TimeoutError``)."""
        while True:
            frame = extract_frame(self._buf, self._max_frame)
            if frame is not None:
                break
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                raise TimeoutError(
                    f"no server frame within {self.timeout}s"
                ) from None
            if not chunk:
                raise ConnectionError("server closed the connection")
            self._buf.extend(chunk)
        ftype, rid, body = frame
        if ftype == T_RESPONSE:
            return WireReply(ftype, rid, value=decode_array(body))
        if ftype == T_ERROR:
            etype, msg = decode_error(body)
            return WireReply(ftype, rid, etype=etype, message=msg)
        if ftype == T_RETRY_AFTER:
            seconds, msg = decode_retry_after(body)
            return WireReply(ftype, rid, retry_after_s=seconds, message=msg)
        if ftype == T_CLOCK:
            return WireReply(ftype, rid, clock=decode_clock_reply(body))
        if ftype in (T_OBS_SNAPSHOT, T_OBS_FLIGHT):
            return WireReply(ftype, rid, obs=decode_obs(body))
        return WireReply(ftype, rid)

    def predict(self, arr, timeout: float = 30.0) -> np.ndarray:
        """Submit one request and block for ITS answer, absorbing
        backpressure until ``timeout``."""
        return self.predict_many([arr], window=1, timeout=timeout)[0]

    def predict_many(
        self, arrs, window: int = 8, timeout: float = 60.0
    ) -> list:
        """Drive ``arrs`` through the server with a bounded pipeline of
        ``window`` outstanding requests; returns the answers in input
        order.  RETRY_AFTER frames are honored (sleep, resubmit); ERROR
        frames raise :class:`WireRemoteError` carrying the remote type."""
        arrs = list(arrs)
        answers: list = [None] * len(arrs)
        pending: dict[int, int] = {}  # wire rid -> input index
        done = 0
        next_i = 0
        end = time.monotonic() + timeout
        while done < len(arrs):
            if time.monotonic() >= end:
                raise TimeoutError(
                    f"{done}/{len(arrs)} answered within {timeout}s"
                )
            while next_i < len(arrs) and len(pending) < max(1, window):
                pending[self.submit(arrs[next_i])] = next_i
                next_i += 1
            reply = self.read()
            if reply.type == T_RESPONSE:
                idx = pending.pop(reply.request_id, None)
                if idx is None:
                    raise WireProtocolError(
                        f"response for unknown request id {reply.request_id}"
                    )
                answers[idx] = reply.value
                done += 1
            elif reply.type == T_RETRY_AFTER:
                idx = pending.pop(reply.request_id, None)
                if idx is None:
                    raise WireProtocolError(
                        f"retry for unknown request id {reply.request_id}"
                    )
                time.sleep(min(max(reply.retry_after_s, 0.0), 1.0))
                pending[self.submit(arrs[idx])] = idx
            elif reply.type == T_ERROR:
                raise WireRemoteError(reply.etype, reply.message or "")
            # PONGs (or future frame types) are ignored here.
        return answers

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass

    def __enter__(self) -> "WireClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

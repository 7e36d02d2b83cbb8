"""Data-plane transport: broker↔server query RPC over TCP.

The port's copy of pinot_tpu/cluster/transport.py, whole. A request
frame pickles only the port's own classes (its QueryContext), so a
fleet that mixes JAX and port processes shares the DataTable bytes
(cluster/datatable.py), never the RPC frames.

Reference analogue: the Netty data plane (pinot-core/.../transport/ —
QueryRouter.submitQuery:90 → ServerChannels → server QueryServer +
InstanceRequestHandler.channelRead0:122 deserializing Thrift
InstanceRequest). Here: length-prefixed pickled frames over TCP sockets
with a thread-per-connection server — the host-side scatter/gather plane.
Device-side data never crosses this wire; servers ship per-table combined
intermediates (the DataTable analogue), brokers merge and reduce.

Pickle is acceptable where Thrift serves in the reference because both ends
are this same trusted process group (in-proc cluster / localhost tests);
the framing keeps the transport swappable for a real codec later.
"""

from __future__ import annotations

import pickle
import socket
import ssl
import struct
import threading
from typing import Callable, Optional

from ..spi import faults

_HDR = struct.Struct(">I")
_MAX_FRAME = 1 << 30
# the TLS handshake's ceiling on an accepted connection
_HANDSHAKE_S = 10.0
# sockets a client may hold to one target, each carrying one call
_POOL_SIZE = 8


def make_server_ssl_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    """TLS for the data plane (reference: Netty channel TLS,
    pinot-core/.../transport/ChannelHandlerFactory with TlsConfig)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


def make_client_ssl_context(cafile: Optional[str] = None,
                            verify: bool = True) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if cafile:
        ctx.load_verify_locations(cafile)
    else:
        # PROTOCOL_TLS_CLIENT starts with zero trust anchors (unlike
        # create_default_context) — CA-signed server certs need system CAs
        ctx.load_default_certs()
    if not verify:  # self-signed dev certs (reference tls "skip server" mode)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


class TransportError(Exception):
    """Connection-level failure — the peer is unreachable or hung up."""


class RemoteError(Exception):
    """The peer was reached and its handler raised — a per-request error,
    NOT a server-health signal (the broker must not mark the instance
    unhealthy or fail over; reference: QueryException in the DataTable vs a
    Netty channel error)."""


def _send_frame(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError("connection closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket):
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if n > _MAX_FRAME:
        raise TransportError(f"frame too large: {n}")
    return pickle.loads(_recv_exact(sock, n))


def _corrupt_payload(payload, c):
    """Apply an injected wire corruption to a decoded response: garble its
    byte fields (integrity checksums downstream must catch it — e.g. the
    DataTable trailer at the broker). Responses with no byte fields degrade
    to a garbled-frame TransportError so the fault is never a silent no-op."""
    if isinstance(payload, (bytes, bytearray)):
        return faults.corrupt_bytes(bytes(payload), c.mode, c.seed, c.index)
    if isinstance(payload, dict):
        hit = False
        out = dict(payload)
        for k, v in payload.items():
            if isinstance(v, (bytes, bytearray)):
                out[k] = faults.corrupt_bytes(bytes(v), c.mode, c.seed,
                                              c.index)
                hit = True
        if hit:
            return out
    raise TransportError(f"garbled response frame: {c}")


class RpcServer:
    """Thread-per-connection request/response server.
    handler(request_obj) → response_obj. Bind to port 0 for an ephemeral
    port; .port reports the bound port."""

    def __init__(self, handler: Callable, host: str = "127.0.0.1", port: int = 0,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 max_inflight_bytes: Optional[int] = None):
        self.handler = handler
        self._ssl = ssl_context
        # request-memory guard (reference: DirectOOMHandler — shed load
        # instead of dying when request buffers exceed the direct-memory
        # budget): frames beyond the budget are drained and refused
        self._budget = max_inflight_bytes
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._closed = threading.Event()
        self._conns: set = set()  # live per-connection sockets
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"rpc-accept-{self.port}", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn: socket.socket) -> Optional[socket.socket]:
        """TLS handshake off the accept loop (a stalled ClientHello must
        not block other connections) and under a timeout."""
        if self._ssl is None:
            return conn
        conn.settimeout(_HANDSHAKE_S)
        try:
            conn = self._ssl.wrap_socket(conn, server_side=True)
            conn.settimeout(None)
            return conn
        except (ssl.SSLError, OSError):
            try:
                conn.close()
            except OSError:
                pass
            return None

    def _reserve(self, n: int) -> bool:
        if self._budget is None:
            return True
        with self._inflight_lock:
            if self._inflight + n > self._budget:
                return False
            self._inflight += n
            return True

    def _release(self, n: int) -> None:
        if self._budget is not None:
            with self._inflight_lock:
                self._inflight -= n

    def _serve_conn(self, conn: socket.socket) -> None:
        handshaken = self._handshake(conn)
        if handshaken is None:
            return
        conn = handshaken
        with self._conns_lock:
            if self._closed.is_set():
                conn.close()
                return
            self._conns.add(conn)
        try:
            self._serve_conn_loop(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _serve_conn_loop(self, conn: socket.socket) -> None:
        import types

        with conn:
            while not self._closed.is_set():
                try:
                    (n,) = _HDR.unpack(_recv_exact(conn, _HDR.size))
                    if n > _MAX_FRAME:
                        return
                    if not self._reserve(n):
                        # drain through a fixed scratch to keep the stream
                        # in sync WITHOUT buffering the frame (the guard
                        # must not itself allocate what it refuses)
                        left = n
                        while left:
                            chunk = conn.recv(min(left, 1 << 16))
                            if not chunk:
                                return
                            left -= len(chunk)
                        try:
                            _send_frame(conn, (
                                "error", "ServerOutOfMemory: request "
                                "buffers exceed the transport memory budget"))
                        except OSError:
                            return
                        continue
                    try:
                        request = pickle.loads(_recv_exact(conn, n))
                    finally:
                        self._release(n)
                except (TransportError, OSError, EOFError):
                    return
                try:
                    result = self.handler(request)
                    if isinstance(result, types.GeneratorType):
                        # streaming response: one ("chunk", x) frame per
                        # yielded item, then ("ok", None) — the gRPC
                        # server-streaming analogue over the framed plane
                        try:
                            for chunk in result:
                                _send_frame(conn, ("chunk", chunk))
                            response = ("ok", None)
                        except Exception as e:  # mid-stream failure
                            response = ("error", f"{type(e).__name__}: {e}")
                    else:
                        response = ("ok", result)
                except Exception as e:  # surface handler errors to the caller
                    response = ("error", f"{type(e).__name__}: {e}")
                try:
                    _send_frame(conn, response)
                except OSError:
                    return

    def close(self) -> None:
        self._closed.set()
        try:
            # close() alone does NOT wake a thread blocked in accept() on
            # Linux — shutdown() does (EINVAL), so the accept thread can
            # actually exit and release its reference to the handler
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # established connections must die too: a per-connection thread
        # blocked in recv() on a still-open socket pins self.handler (and
        # through the bound method, the whole owning server instance)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # join the accept thread: while alive it pins self.handler
        if self._accept_thread is not threading.current_thread():
            self._accept_thread.join(timeout=2.0)


class RpcClient:
    """Pooled connections per target with reconnect-on-failure.

    Up to ``_POOL_SIZE`` sockets (8) may
    carry in-flight calls to one target concurrently. A single pooled
    socket would serialize concurrent queries from different broker
    threads on the wire — the server would only ever see one query at a
    time, so cross-query coalescing could never form a group."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 ssl_context: Optional[ssl.SSLContext] = None):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.pool_size = _POOL_SIZE
        self._ssl = ssl_context
        self._free: list = []  # idle sockets, checkout/checkin under _lock
        self._lock = threading.Lock()
        # caps concurrent in-flight calls at pool_size; excess callers
        # queue here instead of growing the socket count without bound
        self._sem = threading.BoundedSemaphore(self.pool_size)
        # close() bumps the generation: sockets checked out under an
        # older generation are closed on checkin instead of re-pooled
        self._gen = 0

    def _connect(self) -> socket.socket:
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        # create_connection's timeout persists on the socket (it would be
        # the recv timeout too) — restore the request timeout explicitly
        s.settimeout(self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._ssl is not None:
            s = self._ssl.wrap_socket(s, server_hostname=self.host)
        return s

    def _fire_fault(self, point: str):
        """Injection seam: an InjectedDrop kills the pooled socket (the
        peer 'hung up'); an InjectedCorruption is RETURNED — the RPC itself
        proceeds and the caller garbles the response payload, so integrity
        checksums (not connection errors) must catch it; any other injected
        fault surfaces as TransportError — the connection-level failure
        shape, so callers exercise their real failover/retry paths."""
        try:
            faults.FAULTS.fire(point, host=self.host, port=self.port)
        except faults.InjectedCorruption as c:
            return c
        except faults.InjectedDrop as e:
            self.close()
            raise TransportError(
                f"rpc to {self.host}:{self.port} failed: {e}") from None
        except faults.InjectedFault as e:
            raise TransportError(
                f"rpc to {self.host}:{self.port} failed: {e}") from None
        return None

    def call(self, request, retry: bool = True,
             timeout: Optional[float] = None):
        """``retry`` re-sends once on a connection failure (the pooled
        connection may have gone stale between calls). Callers whose
        requests are NOT idempotent — e.g. an mse_stage dispatch, where a
        re-run would consume mailboxes twice — pass retry=False; mailbox
        block deliveries stay retryable because the receiver dedups on
        (sender, seq). ``timeout`` bounds THIS call only (deadline
        propagation: the broker passes its remaining budget) by temporarily
        tightening the socket timeout.

        An armed ``corrupt`` fault on transport.call lets the RPC complete
        and then garbles the response's byte fields — models in-flight wire
        corruption below the app layer; the DataTable checksum at the
        broker must catch it."""
        corruption = None
        if faults.ACTIVE:
            corruption = self._fire_fault("transport.call")
        attempts = (0, 1) if retry else (1,)
        self._sem.acquire()
        try:
            sock = gen = None
            for attempt in attempts:
                try:
                    if sock is None:
                        if attempt == 0:
                            sock, gen = self._checkout()
                        else:
                            # the pooled socket just failed — every idle
                            # peer from the same era is suspect (server
                            # restart), so retry on a FRESH connection
                            with self._lock:
                                gen = self._gen
                            sock = self._connect()
                    if timeout is not None:
                        sock.settimeout(timeout)
                    try:
                        _send_frame(sock, request)
                        status, payload = _recv_frame(sock)
                    finally:
                        if timeout is not None:
                            try:
                                sock.settimeout(self.timeout)
                            except OSError:
                                pass
                    self._checkin(sock, gen)
                    break
                except (TransportError, OSError, EOFError):
                    if sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass
                        sock = None
                    self._flush_free()
                    if attempt == 1:
                        raise TransportError(
                            f"rpc to {self.host}:{self.port} failed")
        finally:
            self._sem.release()
        if status == "error":
            raise RemoteError(payload)
        if corruption is not None:
            payload = _corrupt_payload(payload, corruption)
        return payload

    def call_stream(self, request):
        """Generator over a streaming response: yields each chunk; raises
        RemoteError on a server-side failure (also mid-stream). Uses a
        DEDICATED connection (not the pooled one) so an abandoned or
        long-lived stream never blocks concurrent unary calls — the
        per-stream-channel behavior of the gRPC analogue."""
        if faults.ACTIVE:
            c = self._fire_fault("transport.stream")
            if c is not None:
                # streams have no payload-level checksum yet — degrade a
                # corrupt fault to the connection-failure shape
                raise TransportError(
                    f"stream from {self.host}:{self.port} garbled: {c}")
        try:
            sock = self._connect()
        except OSError:
            raise TransportError(
                f"rpc to {self.host}:{self.port} failed") from None
        try:
            _send_frame(sock, request)
            while True:
                try:
                    status, payload = _recv_frame(sock)
                except (TransportError, OSError, EOFError):
                    raise TransportError(
                        f"stream from {self.host}:{self.port} broke") from None
                if status == "chunk":
                    yield payload
                elif status == "ok":
                    return
                else:
                    raise RemoteError(payload)
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _checkout(self):
        """Pop an idle socket (or dial a fresh one) plus the generation
        it belongs to. May raise OSError from connect."""
        with self._lock:
            if self._free:
                return self._free.pop(), self._gen
            gen = self._gen
        return self._connect(), gen

    def _checkin(self, sock: socket.socket, gen) -> None:
        with self._lock:
            if gen == self._gen and len(self._free) < self.pool_size:
                self._free.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def _flush_free(self) -> None:
        with self._lock:
            free, self._free = self._free, []
        for s in free:
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            self._gen += 1
            free, self._free = self._free, []
        for s in free:
            try:
                s.close()
            except OSError:
                pass

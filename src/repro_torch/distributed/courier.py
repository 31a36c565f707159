"""Courier: a minimal socket RPC layer for program edges (§2.4).

When a ``Program`` node crosses a process boundary its in-memory ``Handle``
degrades to a ``RemoteHandle`` — same call syntax, but each method call is
forwarded to a ``Server`` wrapping the real object in the parent process.

Wire format (length-prefixed pickled frames, one request per response):

    frame    := uint32 big-endian payload length | pickled payload
    request  := (method_name: str, args: tuple, kwargs: dict)
    response := ("ok", result) | ("error", exception)

Errors re-raise in the caller with their original type when the exception
pickles (so e.g. a ``RateLimiterTimeout`` raised inside a remote replay
table is classified identically by local and remote callers); otherwise the
caller gets a ``RemoteError`` carrying the formatted remote traceback.

Servers enforce the node's declared ``interface`` (a method allowlist):
moving a service out-of-process never widens what its clients may call.
Connections are authenticated with an HMAC challenge (the unpickling server
must not accept frames from arbitrary local processes — CWE-502): each
``Server`` owns a random authkey, every accepted connection must answer
``HMAC(authkey, nonce)`` before its first frame is read, and the key
travels to legitimate clients only inside ``RemoteHandle`` pickles (process
spawn payloads / control pipes), never over the socket.
"""
from __future__ import annotations

import dataclasses
import hmac
import pickle
import secrets
import socket
import struct
import threading
import time
import traceback
from typing import Any, Optional, Sequence, Tuple

from repro_torch.distributed.backoff import BackoffPolicy
from repro_torch.telemetry import registry as _telemetry

_LEN = struct.Struct(">I")
_HOST = "127.0.0.1"
_NONCE_BYTES = 16
_DIGEST = "sha256"
_DIGEST_BYTES = 32
_AUTH_OK = b"OK"

# Methods safe to re-execute if the RESPONSE is lost: pure reads and
# latest-wins writes.  For these (and only these) a half-open connection is
# timed out and the call retried on a fresh socket; everything else keeps
# the strict no-retry-after-send rule below, because a lost response may
# mean the server already ran the (non-idempotent) method.
IDEMPOTENT_METHODS = frozenset({
    "get_variables", "get_counts", "size", "stats", "select_action",
    "push", "snapshot", "nodes", "num_pushes", "items",
})
# Recv timeout applied per attempt to idempotent calls: bounds how long a
# half-open connection (peer died without FIN) can stall a retryable read.
IDEMPOTENT_RECV_TIMEOUT_S = 30.0


@dataclasses.dataclass(frozen=True)
class RetryConfig:
    """Client-side retry behaviour for ``RemoteHandle`` calls.

    Two independent knobs, one shared ``BackoffPolicy``:

    - ``reconnect_deadline_s`` bounds the RECONNECT path: connection
      refused/reset before the request was delivered (including a service's
      restart window, and chaos-injected drops).  These are always safe to
      retry for any method — no bytes reached the server — so the client
      keeps retrying with jittered backoff until the deadline, then raises
      ``ServiceUnavailable``.
    - ``max_attempts`` bounds the RESPONSE-LOST path: the request was sent
      but the reply never arrived.  Only ``IDEMPOTENT_METHODS`` retry here
      (the server may already have executed a non-idempotent call).

    Process-global, installed via ``set_retry_config`` — plumbed from
    ``ExperimentConfig.rpc_retry`` into every worker.
    """

    max_attempts: int = 3
    reconnect_deadline_s: float = 5.0
    backoff: BackoffPolicy = BackoffPolicy()

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.reconnect_deadline_s <= 0:
            raise ValueError(f"reconnect_deadline_s must be > 0, "
                             f"got {self.reconnect_deadline_s}")
        if not isinstance(self.backoff, BackoffPolicy):
            raise TypeError(f"backoff must be a BackoffPolicy, "
                            f"got {type(self.backoff).__name__}")


DEFAULT_RETRY = RetryConfig()
_RETRY = DEFAULT_RETRY


def set_retry_config(config: Optional[RetryConfig]):
    """Install a process-wide retry config (None restores the default)."""
    global _RETRY
    if config is not None and not isinstance(config, RetryConfig):
        raise TypeError(f"expected RetryConfig or None, "
                        f"got {type(config).__name__}")
    _RETRY = config if config is not None else DEFAULT_RETRY


def retry_config() -> RetryConfig:
    return _RETRY


# Chaos injection point (see repro_torch.resilience.chaos): when set,
# consulted client-side before every send — may sleep (delay) or raise
# ConnectionError (drop).  Faults fire before any bytes hit the wire, so a
# dropped call is always safe to retry regardless of idempotence.
_RPC_CHAOS = None


def set_rpc_chaos(injector):
    """Install (or clear, with None) a process-wide RPC fault injector."""
    global _RPC_CHAOS
    _RPC_CHAOS = injector

class CourierClosed(ConnectionError):
    """The peer closed the connection (server stopped, or vice versa)."""


class ServiceUnavailable(ConnectionError):
    """The service stayed unreachable past the reconnect deadline (its
    restart window exceeded the budget, or it is down for good) — or, when
    raised server-side, the service is marked down awaiting failover.  A
    ``ConnectionError`` subclass so degradation paths catch transport and
    application unavailability uniformly."""


class AuthenticationError(ConnectionRefusedError):
    """The courier HMAC handshake failed (missing/wrong authkey).  Never
    retried: backoff cannot fix a key mismatch, and fast-failing keeps a
    misconfigured client from hammering the server."""


class RemoteError(RuntimeError):
    """A remote call failed and the original exception could not be pickled
    back; carries the remote type name and formatted traceback."""


def picklable_error(e: BaseException) -> BaseException:
    """Return ``e`` if it survives a pickle ROUND-TRIP (dumps alone is not
    enough: multi-arg ``__init__`` exceptions dump fine but explode on
    loads), else a ``RemoteError`` carrying the formatted traceback.  Shared
    by the courier server and the launcher child error queue so both ship
    identically-shaped errors."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RemoteError(f"{type(e).__name__}: {e}\n"
                           f"--- remote traceback ---\n"
                           f"{traceback.format_exc()}")


def _send_frame(sock: socket.socket, obj: Any) -> int:
    """Send one frame; returns the payload size in bytes (for telemetry)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)
    return len(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError as e:
            e.bytes_read = len(buf)
            raise
        if not chunk:
            err = CourierClosed("connection closed mid-frame"
                                if buf else "connection closed")
            err.bytes_read = len(buf)
            raise err
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Tuple[Any, int]:
    """Receive one frame; returns ``(obj, payload_bytes)``.

    A connection failure (clean EOF or reset — the FIN/RST race makes
    either equally likely when the peer died) before the first byte of
    the length prefix is tagged ``no_response=True`` on the raised
    exception: the peer never wrote a single response byte, which the
    client's retry logic distinguishes from a mid-response failure.
    Timeouts are never tagged (the peer may be alive but slow).
    """
    try:
        (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    except (CourierClosed, OSError) as e:
        if getattr(e, "bytes_read", None) == 0 \
                and not isinstance(e, (socket.timeout, TimeoutError)):
            e.no_response = True
        raise
    return pickle.loads(_recv_exact(sock, length)), length


def _rpc_metrics(cache: dict, side: str, name: str, method: str):
    """Lazy per-method RPC metrics: ``(latency_ms hist, bytes_sent counter,
    bytes_recv counter)``, or None while telemetry is disabled.

    Checked at CALL time, not construction time, because handles unpickle
    in spawn children *before* ``WorkerTelemetry.install()`` configures the
    child's registry.  Cached per method after the first enabled call; the
    benign dict race under concurrent serve threads at worst recreates the
    same tuple.
    """
    metrics = cache.get(method)
    if metrics is None:
        if not _telemetry.enabled():
            return None
        base = f"courier/{side}/{name or 'anon'}/{method}"
        metrics = (_telemetry.histogram(f"{base}/latency_ms"),
                   _telemetry.counter(f"{base}/bytes_sent"),
                   _telemetry.counter(f"{base}/bytes_recv"))
        cache[method] = metrics
    return metrics


class Server:
    """Serve method calls on ``target`` over a localhost socket.

    One lightweight thread per client connection (clients hold persistent
    connections); ``interface`` restricts which methods may be invoked.
    """

    def __init__(self, target: Any, interface: Optional[Sequence[str]] = None,
                 name: str = "courier", host: str = _HOST, port: int = 0,
                 authkey: Optional[bytes] = None):
        self.target = target
        self.name = name
        self.interface = tuple(interface) if interface is not None else None
        self.authkey = authkey if authkey is not None \
            else secrets.token_bytes(32)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._stopped = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns = set()
        self._conns_lock = threading.Lock()
        self._rpc_metrics: dict = {}

    def start(self) -> "Server":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"courier/{self.name}",
            daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:   # listening socket closed by stop()
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name=f"courier/{self.name}/conn",
                             daemon=True).start()

    def _authenticate(self, conn: socket.socket) -> bool:
        """Challenge-response before any frame is unpickled: send a nonce,
        require HMAC(authkey, nonce) back."""
        try:
            nonce = secrets.token_bytes(_NONCE_BYTES)
            conn.sendall(nonce)
            digest = _recv_exact(conn, _DIGEST_BYTES)
            expected = hmac.new(self.authkey, nonce, _DIGEST).digest()
            if not hmac.compare_digest(digest, expected):
                return False
            conn.sendall(_AUTH_OK)
            return True
        except (CourierClosed, OSError):
            return False

    def _serve_conn(self, conn: socket.socket):
        try:
            if not self._authenticate(conn):
                return
            while not self._stopped.is_set():
                try:
                    (method, args, kwargs), bytes_in = _recv_frame(conn)
                except (CourierClosed, OSError, EOFError):
                    return
                metrics = _rpc_metrics(self._rpc_metrics, "server",
                                       self.name, method)
                t0 = time.monotonic() if metrics else 0.0
                response = self._dispatch(method, args, kwargs)
                try:
                    bytes_out = _send_frame(conn, response)
                except OSError:
                    return
                except Exception as e:
                    # the RESULT failed to pickle (dumps happens before any
                    # bytes hit the wire): answer with an error frame
                    # instead of silently killing the connection.
                    bytes_out = _send_frame(conn, ("error", RemoteError(
                        f"response of {self.name!r}.{method} could not be "
                        f"pickled: {type(e).__name__}: {e}")))
                if metrics:
                    latency, sent, received = metrics
                    latency.observe((time.monotonic() - t0) * 1000.0)
                    sent.inc(bytes_out)
                    received.inc(bytes_in)
        except OSError:
            return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, method: str, args: tuple, kwargs: dict):
        try:
            if self.interface is not None and method not in self.interface:
                raise AttributeError(
                    f"{method!r} is not in service {self.name!r}'s declared "
                    f"interface {self.interface}")
            result = getattr(self.target, method)(*args, **kwargs)
            return ("ok", result)
        except BaseException as e:   # noqa: BLE001 — forwarded to the caller
            return ("error", picklable_error(e))

    def stop(self):
        self._stopped.set()
        # shutdown() BEFORE close(): the accept thread is blocked inside
        # the accept(2) syscall, which on Linux keeps the open file
        # description referenced — a bare close() would leave the socket
        # LISTENING (and the port unbindable for a failover re-bind at the
        # same address) until that thread wakes, which it never would.
        # shutdown() interrupts the blocked accept immediately.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            # same reasoning: serve threads are blocked in recv(2)
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    close = stop


class RemoteHandle:
    """Pickle-able RPC stub: ``handle.method(...)`` forwards over courier.

    Drop-in for the in-memory ``Handle`` — node code cannot tell which one
    it holds (the Launchpad transparency property, now across processes).
    The socket is opened lazily and never pickled; unpickling in another
    process yields a fresh stub bound to the same server address.
    """

    def __init__(self, address: Tuple[str, int], name: str = "",
                 interface: Optional[Sequence[str]] = None,
                 authkey: Optional[bytes] = None):
        self._address = tuple(address)
        self._name = name
        self._interface = tuple(interface) if interface is not None else None
        self._authkey = authkey
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._rpc_metrics: dict = {}
        self._m_retries = None
        self._m_reconnects = None

    def _retries_metric(self):
        # Lazy like _rpc_metrics: handles unpickle before the child's
        # telemetry registry is configured.
        if self._m_retries is None:
            if not _telemetry.enabled():
                return None
            self._m_retries = _telemetry.counter(
                f"courier/client/{self._name or 'anon'}/retries")
        return self._m_retries

    def _reconnects_metric(self):
        if self._m_reconnects is None:
            if not _telemetry.enabled():
                return None
            self._m_reconnects = (
                _telemetry.counter("courier/reconnects"),
                _telemetry.counter(
                    f"courier/client/{self._name or 'anon'}/reconnects"))
        return self._m_reconnects

    @property
    def address(self) -> Tuple[str, int]:
        return self._address

    @property
    def node_name(self) -> str:
        return self._name

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._address, timeout=30)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        try:
            nonce = _recv_exact(sock, _NONCE_BYTES)
            key = self._authkey if self._authkey is not None else b""
            sock.sendall(hmac.new(key, nonce, _DIGEST).digest())
            if _recv_exact(sock, len(_AUTH_OK)) != _AUTH_OK:
                raise CourierClosed("bad auth ack")
        except (CourierClosed, OSError) as e:
            try:
                sock.close()
            except OSError:
                pass
            raise AuthenticationError(
                f"courier authentication with {self._name!r} @ "
                f"{self._address} failed (missing/wrong authkey)") from e
        return sock

    def _drop_socket(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _reconnect_backoff(self, cause: BaseException, reconnects: int,
                           deadline: Optional[float],
                           cfg: RetryConfig) -> float:
        """Sleep before the next reconnect attempt, or raise
        ``ServiceUnavailable`` once the per-call deadline has passed.
        Returns the deadline (set lazily at the first failure, so healthy
        calls never pay a clock read)."""
        now = time.monotonic()
        if deadline is None:
            deadline = now + cfg.reconnect_deadline_s
        if now >= deadline:
            raise ServiceUnavailable(
                f"service {self._name!r} @ {self._address} unreachable for "
                f"{cfg.reconnect_deadline_s:.1f}s "
                f"({reconnects} reconnect attempts): "
                f"{type(cause).__name__}: {cause}") from cause
        time.sleep(min(cfg.backoff.delay(reconnects),
                       max(deadline - now, 0.0)))
        return deadline

    def call(self, method: str, *args, **kwargs):
        metrics = _rpc_metrics(self._rpc_metrics, "client",
                               self._name, method)
        t0 = time.monotonic() if metrics else 0.0
        idempotent = method in IDEMPOTENT_METHODS
        cfg = _RETRY
        retries = 0      # response-lost retries (idempotent methods only)
        reconnects = 0   # pre-delivery failures retried under the deadline
        deadline = None
        with self._lock:
            # Failures BEFORE the request was delivered — connect refused/
            # reset (a service's restart window), send failure (sendall
            # raised, so the full frame never left this process), or an
            # injected chaos drop — are safe to retry for ANY method: the
            # server cannot have executed the call.  These reconnect with
            # jittered backoff until ``reconnect_deadline_s``, then raise
            # ``ServiceUnavailable``.  Auth failures fast-fail (a wrong key
            # is not transient).  After a send went through there is NO
            # retry for general methods: the server may already have run
            # the (non-idempotent) call, so a lost response must surface as
            # an error rather than silently run the method twice.
            # IDEMPOTENT_METHODS relax this: their recv is bounded by a
            # timeout (half-open peers) and retried on a fresh connection,
            # up to ``max_attempts``.
            while True:
                try:
                    if _RPC_CHAOS is not None:
                        _RPC_CHAOS.before_send()
                except ConnectionError as e:
                    self._drop_socket()
                    deadline = self._reconnect_backoff(
                        e, reconnects, deadline, cfg)
                    reconnects += 1
                    continue
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                except AuthenticationError:
                    raise
                except (ConnectionError, OSError) as e:
                    deadline = self._reconnect_backoff(
                        e, reconnects, deadline, cfg)
                    reconnects += 1
                    continue
                try:
                    bytes_out = _send_frame(self._sock,
                                            (method, args, kwargs))
                except (ConnectionError, OSError) as e:
                    self._drop_socket()
                    deadline = self._reconnect_backoff(
                        e, reconnects, deadline, cfg)
                    reconnects += 1
                    continue
                if idempotent:
                    self._sock.settimeout(IDEMPOTENT_RECV_TIMEOUT_S)
                try:
                    (status, payload), bytes_in = _recv_frame(self._sock)
                except (CourierClosed, ConnectionError, OSError) as e:
                    self._drop_socket()
                    if getattr(e, "no_response", False):
                        # Keep-alive race: the connection died (clean EOF
                        # or reset) before a single response byte.  Either
                        # the frame only made it into the local TCP buffer
                        # of a connection whose peer was already gone, or a
                        # dying server accepted + authed and then shut the
                        # connection without dispatching — in both cases
                        # the handler never responded, so treat it like a
                        # pre-delivery failure and reconnect, for ANY
                        # method.  (The residual window — server executed
                        # the call, then died before writing byte one of
                        # the response — is exactly the state a failover
                        # restore rolls back to its last snapshot, so
                        # retrying is the correct semantics there too.)
                        # Mid-response failures and timeouts keep the
                        # strict rule below: the server saw the call and
                        # may have run it to completion.
                        deadline = self._reconnect_backoff(
                            e, reconnects, deadline, cfg)
                        reconnects += 1
                        continue
                    retries += 1
                    if not idempotent or retries >= cfg.max_attempts:
                        raise
                    time.sleep(cfg.backoff.delay(retries - 1))
                    continue
                if idempotent:
                    self._sock.settimeout(None)
                break
        if retries:
            m_retries = self._retries_metric()
            if m_retries:
                m_retries.inc(retries)
        if reconnects:
            m_reconnects = self._reconnects_metric()
            if m_reconnects:
                for m in m_reconnects:
                    m.inc(reconnects)
        if metrics:
            latency, sent, received = metrics
            latency.observe((time.monotonic() - t0) * 1000.0)
            sent.inc(bytes_out)
            received.inc(bytes_in)
        if status == "error":
            raise payload
        return payload

    def __getattr__(self, item):
        # underscore-prefixed names (which include all dunder probes) are
        # never forwarded as remote methods
        if item.startswith("_"):
            raise AttributeError(item)
        if self._interface is not None and item not in self._interface:
            raise AttributeError(
                f"{item!r} is not in node {self._name!r}'s declared "
                f"interface {self._interface}")
        return _RemoteMethod(self, item)

    def dereference(self):
        """Parity with Handle: a remote handle dereferences to itself (there
        is no local instance on this side of the boundary)."""
        return self

    def close(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def __reduce__(self):
        return (RemoteHandle,
                (self._address, self._name, self._interface, self._authkey))

    def __repr__(self):
        return (f"RemoteHandle({self._name!r} @ "
                f"{self._address[0]}:{self._address[1]})")


class _RemoteMethod:
    """Bound remote method (picklable, reusable)."""

    def __init__(self, handle: RemoteHandle, method: str):
        self._handle = handle
        self._method = method

    def __call__(self, *args, **kwargs):
        return self._handle.call(self._method, *args, **kwargs)

    def __reduce__(self):
        return (_RemoteMethod, (self._handle, self._method))


def serve(target: Any, interface: Optional[Sequence[str]] = None,
          name: str = "courier") -> Tuple[Server, RemoteHandle]:
    """Wrap ``target`` in a started courier server and return
    ``(server, handle)`` — the one-liner for exporting any object over RPC."""
    server = Server(target, interface=interface, name=name).start()
    return server, RemoteHandle(server.address, name=name,
                                interface=interface,
                                authkey=server.authkey)

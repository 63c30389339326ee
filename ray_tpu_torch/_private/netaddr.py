"""TCP channels for the disaggregated serving path's KV-block pulls
(`ray_tpu_torch.serve.disagg`): the address plumbing of
`ray_tpu/_private/netaddr.py` (the port imports nothing of `ray_tpu`)
over plain `multiprocessing.connection` connections with the same HMAC
authkey handshake.

The port's channels differ from the reference's in three ways. They are
TCP only ("host:port"). They carry no coalescing frame layer: a pull is
one request and one reply of a header and raw frames, so there is
nothing to coalesce. And every wait on them is bounded: the dial, the
handshake, and each read and write of the connection's life give up
after the ``timeout`` it was opened with (``SO_RCVTIMEO`` and
``SO_SNDTIMEO``), raising `OSError`. Nagle's algorithm is off, so a
frame written behind an unacknowledged one leaves at once instead of
waiting for the peer's delayed ACK.

`client` connections consult the ``netaddr.send`` / ``netaddr.recv``
fault sites while a plan that declares them is installed
(`ray_tpu_torch.util.faults.maybe_wrap_connection`).
"""

from __future__ import annotations

import socket
import struct
import threading
from multiprocessing import connection

from ray_tpu_torch._private import config
from ray_tpu_torch._private import constants  # noqa: F401  (defines NODE_IP)
from ray_tpu_torch.util import faults


def parse(address) -> tuple:
    """'host:port' -> (host, port); a tuple passes through."""
    if isinstance(address, tuple):
        return address
    host, _, port = address.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _open(sock: socket.socket, timeout: float) -> connection.Connection:
    """A blocking `Connection` over the TCP socket ``sock`` whose every
    read and write gives up after ``timeout`` seconds."""
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sec = int(timeout)
    tv = struct.pack("ll", sec, int((timeout - sec) * 1e6))
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
    return connection.Connection(sock.detach())


def client(address, authkey: bytes, timeout: float = 30.0):
    """Dial ``address`` and run the client's side of the handshake, each
    bounded by ``timeout``. Raises `OSError` on a refused, unreachable or
    silent peer and `multiprocessing.AuthenticationError` on a peer that
    is not a listener of this key."""
    conn = _open(socket.create_connection(parse(address), timeout=timeout),
                 timeout)
    try:
        connection.answer_challenge(conn, authkey)
        connection.deliver_challenge(conn, authkey)
    except BaseException:
        conn.close()
        raise
    return faults.maybe_wrap_connection(conn, "netaddr")


def listener(address) -> socket.socket:
    """A TCP socket bound to ``address`` and listening; `accept` peers
    from it and hand each to `serve`."""
    return socket.create_server(parse(address))


def serve(sock: socket.socket, authkey: bytes, timeout: float = 30.0):
    """The server's side of an accepted socket: the handshake, bounded by
    ``timeout`` as every later read and write is."""
    conn = _open(sock, timeout)
    try:
        connection.deliver_challenge(conn, authkey)
        connection.answer_challenge(conn, authkey)
    except BaseException:
        conn.close()
        raise
    return conn


def bound_address(sock: socket.socket) -> str:
    """'host:port' a peer should dial for the listening ``sock``; resolves
    the ephemeral port and a 0.0.0.0 bind to the advertised host."""
    host, port = sock.getsockname()[:2]
    if host in ("0.0.0.0", ""):
        host = advertise_host()
    return f"{host}:{port}"


# The UDP-socket interface probe is memoized (it cannot change without the
# host's routing table changing) and the NODE_IP override is re-read per
# call — an env read, not a socket. config.reset_caches() flushes the probe.
_advertise_lock = threading.Lock()
_advertised: str | None = None


@config.on_reset
def _reset_advertise_cache() -> None:
    global _advertised
    with _advertise_lock:
        _advertised = None


def advertise_host() -> str:
    """The address other machines should dial for listeners bound on
    0.0.0.0 (reference: node_ip_address detection in services.py)."""
    override = config.get("NODE_IP")
    if override:
        return override
    global _advertised
    host = _advertised
    if host is not None:
        return host
    with _advertise_lock:
        if _advertised is None:
            try:
                # a UDP "connection" to a public address picks the
                # outbound iface without sending anything
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.connect(("8.8.8.8", 80))
                _advertised = s.getsockname()[0]
                s.close()
            except OSError:
                _advertised = "127.0.0.1"
        return _advertised

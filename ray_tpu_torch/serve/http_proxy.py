"""HTTP ingress — async data plane with response streaming; the port of
`ray_tpu/serve/http_proxy.py` on the standard library.

Counterpart of the reference's `HTTPProxy`
(`serve/_private/http_proxy.py:189`, uvicorn/ASGI + actor wrapper :858,
streaming `replica.py:249`). The JAX package serves with aiohttp, which
the card's machine does not have, so this proxy runs
`asyncio.start_server` on a dedicated event loop inside the proxy actor
with a small HTTP/1.1 parser (`_read_request`), keeping the reference's
behaviour on the wire: the status codes, the bodies and their
``Content-Type``, ``Retry-After`` on a shed, and chunked transfer of a
streamed body. Request handling never blocks the loop — replica picks
and submits run on a small executor and ObjectRef results are awaited
via futures. Streaming deployments (generators / StreamingResponse) are
transferred replica→proxy in chunk batches and written through an HTTP
chunked response, each write awaiting the socket's drain, so a slow
client doesn't hold a replica thread or the loop, and the first byte
leaves before the generator finishes. A client that goes away mid-stream
(its end of the connection at EOF, or a failed write) cancels the
replica-side stream.

Request mapping: the deployment callable receives a `Request` with
method/path/query/headers/body; `json()` parses the body. Responses:
bytes/str passed through; StreamingResponse/generators stream chunked;
any other object is JSON-encoded.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import http
import json
import random
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

from ray_tpu_torch._private.constants import (
    SERVE_RETRY_BASE_S,
    SERVE_RETRY_CAP_S,
    SERVE_RETRY_MAX_ATTEMPTS,
)
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.replica import STREAM_MARKER

# the reference's aiohttp `client_max_size`
_MAX_BODY = 1 << 28
_MAX_LINE = 1 << 16
_MAX_HEADERS = 100


@dataclass
class Request:
    method: str
    path: str
    query: dict = field(default_factory=dict)
    headers: dict = field(default_factory=dict)
    body: bytes = b""

    def json(self):
        return json.loads(self.body or b"null")


class _Response:
    """A whole (not streamed) response: what the reference's
    ``web.Response`` / ``web.json_response`` put on the wire."""

    def __init__(self, status: int, body: bytes = b"",
                 content_type: str | None = None,
                 headers: dict | None = None):
        self.status = status
        self.body = body
        self.headers = dict(headers or {})
        if content_type is not None:
            self.headers["Content-Type"] = content_type

    @classmethod
    def json(cls, obj, status: int = 200, headers: dict | None = None):
        return cls(status, json.dumps(obj).encode(),
                   "application/json; charset=utf-8", headers)

    @classmethod
    def text(cls, text: str, status: int):
        return cls(status, text.encode(), "text/plain; charset=utf-8")


class _BadRequest(Exception):
    pass


def _status_line(status: int) -> bytes:
    try:
        reason = http.HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    return f"HTTP/1.1 {status} {reason}\r\n".encode("latin-1")


def _head(status: int, headers: dict) -> bytes:
    lines = [_status_line(status)]
    for k, v in headers.items():
        lines.append(f"{k}: {v}\r\n".encode("latin-1"))
    lines.append(b"\r\n")
    return b"".join(lines)


async def _readline(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise _BadRequest("truncated line") from None
        return b""
    except asyncio.LimitOverrunError:
        raise _BadRequest("line too long") from None
    return line


async def _read_request(reader: asyncio.StreamReader):
    """One HTTP/1.1 request off the connection: ``(method, target,
    version, headers, body)``, or None at a clean EOF between requests.
    Bodies come by ``Content-Length`` or chunked transfer coding."""
    line = await _readline(reader)
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _BadRequest(f"bad request line {line[:80]!r}")
    method, target, version = parts
    headers: dict = {}
    while True:
        h = await _readline(reader)
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise _BadRequest("connection closed inside the headers")
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep or not name.strip() or len(headers) >= _MAX_HEADERS:
            raise _BadRequest(f"bad header {h[:80]!r}")
        headers[name.strip()] = value.strip()
    low = {k.lower(): v for k, v in headers.items()}
    return method, target, version, headers, low


async def _read_body(reader, writer, low: dict) -> bytes:
    if low.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if "chunked" in low.get("transfer-encoding", "").lower():
        out = bytearray()
        while True:
            size_line = await _readline(reader)
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise _BadRequest("bad chunk size") from None
            if size == 0:
                while (await _readline(reader)) not in (b"\r\n", b"\n", b""):
                    pass                          # trailers
                return bytes(out)
            if len(out) + size > _MAX_BODY:
                raise _BadRequest("body too large")
            out += await reader.readexactly(size)
            await _readline(reader)
    n = low.get("content-length")
    if n is None:
        return b""
    try:
        n = int(n)
    except ValueError:
        raise _BadRequest("bad Content-Length") from None
    if n < 0 or n > _MAX_BODY:
        raise _BadRequest("bad Content-Length")
    return await reader.readexactly(n) if n else b""


class HTTPProxy:
    # SLO-admission knobs: how long one controller latency snapshot
    # stays fresh, and how long a non-sheddable request queues at the
    # proxy waiting for the histograms to come back under target.
    _SLO_TTL_S = 0.25
    _SLO_QUEUE_S = 0.5
    # how often a stream's drain checks that its client is still there
    _CLIENT_POLL_S = 0.2

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host, self.port = host, port
        self._routes: dict = {}           # prefix -> (deployment, app)
        self._handles: dict = {}
        # SLO-aware admission state: cached controller latency snapshot
        # + shed/queue counters (stats() -> Prometheus bridge)
        self._slo_mu = threading.Lock()
        self._slo_cache: dict = {}
        self._slo_fetched = -1e9
        self._slo_sheds = 0
        self._slo_queued = 0
        from ray_tpu_torch.util import telemetry as _telemetry
        self._telemetry_name = _telemetry.register_stats_source(
            _telemetry.next_name("http_proxy#"), self, kind="http_proxy")
        # picks/submits touch blocking plumbing (non-blocking wait() for
        # load probes, socket sends): keep them off the event loop.
        # Streaming drains get their OWN pool — a drain can legitimately
        # block minutes between chunk batches, and sharing one capped pool
        # would let 16 slow streams starve request admission entirely.
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="serve-proxy")
        self._stream_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="serve-stream")
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._server = None
        self._boot_error: BaseException | None = None

        def run():
            asyncio.set_event_loop(self._loop)
            try:
                self._server = self._loop.run_until_complete(
                    asyncio.start_server(self._serve_connection, host, port,
                                         limit=_MAX_LINE))
                self.port = self._server.sockets[0].getsockname()[1]
            except BaseException as e:
                self._boot_error = e
                return
            finally:
                self._started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serve-http")
        self._thread.start()
        if not self._started.wait(30):
            raise RuntimeError("HTTP proxy failed to start within 30s")
        if self._boot_error is not None:
            # bind failures must raise at construction (a silently dead
            # proxy reporting the requested port helps nobody)
            raise RuntimeError(
                f"HTTP proxy failed to bind {host}:{port}: "
                f"{self._boot_error}")

    # -- actor control surface --------------------------------------------

    def ready(self) -> dict:
        return {"host": self.host, "port": self.port}

    def set_route(self, prefix: str, deployment_name: str,
                  app_name: str) -> bool:
        self._routes[prefix.rstrip("/") or "/"] = (deployment_name, app_name)
        return True

    def get_routes(self) -> dict:
        return dict(self._routes)

    def stop(self) -> bool:
        async def _shutdown():
            self._server.close()
            await self._server.wait_closed()
            self._loop.stop()
        asyncio.run_coroutine_threadsafe(_shutdown(), self._loop)
        return True

    # -- the connection ---------------------------------------------------

    async def _serve_connection(self, reader, writer):
        """Requests one after another on a kept-alive connection until
        the client closes it, asks to (``Connection: close``, or
        HTTP/1.0 without keep-alive), sends something unparseable (400),
        or a streamed response is abandoned."""
        try:
            while True:
                try:
                    req = await _read_request(reader)
                    if req is None:
                        return
                    method, target, version, headers, low = req
                    body = await _read_body(reader, writer, low)
                except (_BadRequest, asyncio.IncompleteReadError) as e:
                    await self._send(writer, _Response.text(
                        f"400: Bad Request ({e})", 400), close=True)
                    return
                conn = low.get("connection", "").lower()
                keep = (conn != "close" if version == "HTTP/1.1"
                        else conn == "keep-alive")
                split = urllib.parse.urlsplit(target)
                query: dict = {}
                for k, v in urllib.parse.parse_qsl(split.query,
                                                   keep_blank_values=True):
                    query.setdefault(k, v)      # the first value wins
                # the deployment sees the headers as sent (a plain dict,
                # name case kept); the proxy looks them up in `low`
                request = Request(method=method,
                                  path=urllib.parse.unquote(split.path),
                                  query=query, headers=dict(headers),
                                  body=body)
                resp = await self._respond(request, low)
                if isinstance(resp, tuple):      # (replica, stream marker)
                    if not await self._stream_out(reader, writer, *resp):
                        return
                else:
                    await self._send(writer, resp, close=not keep)
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _send(self, writer, resp: _Response, close: bool = False):
        headers = dict(resp.headers)
        headers["Content-Length"] = str(len(resp.body))
        if close:
            headers["Connection"] = "close"
        writer.write(_head(resp.status, headers) + resp.body)
        await writer.drain()

    # -- request path -----------------------------------------------------

    def _match(self, path: str):
        best = None
        for prefix, target in self._routes.items():
            if path == prefix or path.startswith(
                    prefix if prefix.endswith("/") else prefix + "/") \
                    or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, target)
        return best

    async def _respond(self, request: Request, low: dict):
        """The response to one request: a whole `_Response`, or
        ``(replica, marker)`` for a body the replica streams. ``low``
        holds the request's headers by lower-case name."""
        match = self._match(request.path)
        if match is None:
            return _Response(404)
        _, (dep, app_name) = match
        key = (dep, app_name)
        if key not in self._handles:
            self._handles[key] = DeploymentHandle(dep, app_name)
        handle = self._handles[key]
        # Priority class rides HTTP as `X-Serve-Priority: <int>` (or a
        # `?priority=<int>` query param; the header wins). The proxy only
        # validates the int here — range checks belong to the engine,
        # which knows its own class count.
        raw_pri = low.get("x-serve-priority", request.query.get("priority"))
        priority = 0
        if raw_pri is not None:
            try:
                priority = int(raw_pri)
                handle = handle.options(priority=priority)
            except (TypeError, ValueError):
                return _Response.json(
                    {"error": "bad_priority",
                     "detail": f"priority must be an int, got {raw_pri!r}"},
                    status=400)
        # SLO-aware admission (disaggregated serving): a request may
        # declare TTFT/TPOT targets; they are checked against the
        # routed deployment's LIVE latency histograms (controller
        # scrape). Unsatisfiable + lowest class -> immediate 429 shed;
        # higher classes queue briefly instead (never SLO-shed).
        raw_ttft = low.get("x-slo-ttft-ms", request.query.get("slo_ttft_ms"))
        raw_tpot = low.get("x-slo-tpot-ms", request.query.get("slo_tpot_ms"))
        if raw_ttft is not None or raw_tpot is not None:
            reject = await self._slo_admit(dep, app_name, raw_ttft,
                                           raw_tpot, priority)
            if reject is not None:
                return reject
        from ray_tpu_torch.util import tracing as _tracing
        root = token = None
        if _tracing.tracing_enabled():
            # Root span of the distributed trace: everything downstream —
            # handle → replica → engine flight recorder — joins this
            # trace_id via TaskSpec stamping + contextvars.
            root, token = _tracing.start_span(
                "http.request",
                {"method": request.method, "path": request.path,
                 "deployment": dep})
        loop = asyncio.get_running_loop()
        from ray_tpu_torch import exceptions as _exc
        attempts = max(1, SERVE_RETRY_MAX_ATTEMPTS)
        try:
            try:
                for attempt in range(attempts):
                    try:
                        ref, replica = await loop.run_in_executor(
                            self._pool, self._call_in_ctx, handle, request,
                            root)
                        result = await self._aget(ref)
                        break
                    except (_exc.ActorDiedError,
                            _exc.WorkerCrashedError):
                        # safely retryable: nothing has been written to
                        # the client yet and a dead replica can never
                        # deliver the result. (Deaths mid-STREAM abort
                        # the chunked response instead — the proxy can't
                        # rewind bytes already on the wire; token-level
                        # failover lives in DeploymentHandle.stream.)
                        if attempt + 1 >= attempts:
                            raise
                        await loop.run_in_executor(
                            self._pool,
                            lambda: handle._refresh(force=True))
                        delay = min(SERVE_RETRY_CAP_S,
                                    SERVE_RETRY_BASE_S * (2 ** attempt))
                        await asyncio.sleep(
                            delay * (0.5 + random.random() / 2))
            except Exception as e:
                if root is not None:
                    root["status"] = "ERROR"
                    root["attributes"]["exception"] = repr(e)
                return self._error_response(e)
            if isinstance(result, dict) and STREAM_MARKER in result:
                return replica, result
            if isinstance(result, bytes):
                body, ctype = result, "application/octet-stream"
            elif isinstance(result, str):
                body, ctype = result.encode(), "text/plain"
            else:
                body, ctype = (json.dumps(result).encode(),
                               "application/json")
            return _Response(200, body, ctype)
        finally:
            if root is not None:
                _tracing.end_span(root, token)

    # -- SLO-aware admission ----------------------------------------------

    async def _slo_snapshot(self, dep: str, app_name: str,
                            force: bool = False):
        """This deployment's live latency view, from a briefly-cached
        controller `get_slo_snapshot` RPC (the cache keeps admission off
        the controller's hot path at high request rates). None = no view
        yet (no engine-backed replica has reported), which admits."""
        now = time.monotonic()
        with self._slo_mu:
            if not force and now - self._slo_fetched < self._SLO_TTL_S:
                return self._slo_cache.get(f"{app_name}:{dep}")

        def fetch():
            import ray_tpu_torch
            from ray_tpu_torch.serve.controller import get_controller
            try:
                return ray_tpu_torch.get(
                    get_controller().get_slo_snapshot.remote(), timeout=5)
            except Exception:
                return {}

        loop = asyncio.get_running_loop()
        snaps = await loop.run_in_executor(self._pool, fetch)
        with self._slo_mu:
            self._slo_cache = snaps
            self._slo_fetched = now
        return snaps.get(f"{app_name}:{dep}")

    async def _slo_admit(self, dep: str, app_name: str, raw_ttft,
                         raw_tpot, priority: int):
        """Admission verdict for a request carrying SLO targets: None to
        admit, or the error response to return. A target is
        unsatisfiable when the deployment's live p99 already exceeds it
        — admitting would knowingly blow the SLO and load the pool for
        nothing. Class 0 sheds (429 + Retry-After); higher classes are
        queued up to `_SLO_QUEUE_S` for the histograms to recover, then
        admitted regardless — priority work is delayed, never dropped
        here (the engine's own admission still protects the pool)."""
        try:
            ttft = float(raw_ttft) if raw_ttft is not None else None
            tpot = float(raw_tpot) if raw_tpot is not None else None
        except (TypeError, ValueError):
            return _Response.json(
                {"error": "bad_slo",
                 "detail": "X-SLO-TTFT-MS / X-SLO-TPOT-MS must be "
                           f"numbers, got {raw_ttft!r}/{raw_tpot!r}"},
                status=400)

        def ok(snap) -> bool:
            return ((ttft is None
                     or ttft >= snap.get("ttft_ms_p99", 0.0))
                    and (tpot is None
                         or tpot >= snap.get("tpot_ms_p99", 0.0)))

        snap = await self._slo_snapshot(dep, app_name)
        if snap is None or ok(snap):
            return None
        if priority <= 0:
            with self._slo_mu:
                self._slo_sheds += 1
            return _Response.json(
                {"error": "slo_shed",
                 "detail": f"deployment {dep!r} p99 "
                           f"ttft={snap.get('ttft_ms_p99', 0.0):.1f}ms/"
                           f"tpot={snap.get('tpot_ms_p99', 0.0):.1f}ms "
                           "exceeds the request's SLO targets"},
                status=429, headers={"Retry-After": "1"})
        with self._slo_mu:
            self._slo_queued += 1
        deadline = time.monotonic() + self._SLO_QUEUE_S
        while time.monotonic() < deadline:
            await asyncio.sleep(self._SLO_TTL_S)
            snap = await self._slo_snapshot(dep, app_name, force=True)
            if snap is None or ok(snap):
                break
        return None

    def stats(self) -> dict:
        """SLO-admission counters, published through the stats bridge as
        ``http_proxy_*`` series: ``slo_sheds`` is requests 429-shed for
        unsatisfiable SLO targets, ``slo_queued`` is requests delayed at
        the proxy instead (non-zero priority class), and ``routes`` is
        the registered route count."""
        with self._slo_mu:
            return {"slo_sheds": self._slo_sheds,
                    "slo_queued": self._slo_queued,
                    "routes": len(self._routes)}

    def _call_in_ctx(self, handle, req, span):
        """Run the handle call on the pool WITH the request's trace
        context: `loop.run_in_executor` does not propagate contextvars,
        so the submit-side TaskSpec stamping would otherwise never see
        the proxy's root span."""
        if span is None:
            return handle.remote_detailed(req)
        from ray_tpu_torch.util import tracing as _tracing
        token = _tracing.attach_context(span)
        try:
            return handle.remote_detailed(req)
        finally:
            _tracing.detach_context(token)

    def _error_response(self, e: BaseException):
        """Typed failure mapping: overload shedding surfaces as 429 with
        a Retry-After hint (clients back off instead of hammering a full
        engine), timeouts as 504; everything else stays 500."""
        from ray_tpu_torch.exceptions import GetTimeoutError, OverloadedError
        if isinstance(e, OverloadedError):
            return _Response.json(
                {"error": "overloaded", "detail": str(e)},
                status=429, headers={"Retry-After": "1"})
        if isinstance(e, (GetTimeoutError, TimeoutError,
                          asyncio.TimeoutError)):
            return _Response.text(str(e), 504)
        return _Response.text(str(e), 500)

    async def _stream_out(self, reader, writer, replica,
                          marker: dict) -> bool:
        """Drain a replica-side generator into a chunked HTTP response
        (reference: streaming replica responses, replica.py:249). Each
        chunk batch is awaited while watching the client: a connection
        at EOF, or a write that fails, cancels the replica-side
        generator and ends the connection. Returns whether the
        connection may carry another request."""
        stream_id = marker[STREAM_MARKER]
        writer.write(_head(marker.get("status", 200), {
            "Content-Type": marker.get("content_type",
                                       "application/octet-stream"),
            "Transfer-Encoding": "chunked"}))
        finished = False
        try:
            await writer.drain()
            while True:
                pull = asyncio.ensure_future(self._aget(
                    replica.next_chunks.remote(stream_id),
                    pool=self._stream_pool))
                while not pull.done():
                    await asyncio.wait([pull], timeout=self._CLIENT_POLL_S)
                    if not pull.done() and reader.at_eof():
                        pull.cancel()
                        raise ConnectionResetError(
                            "client closed the connection mid-stream")
                chunks, done = pull.result()
                if chunks is None:
                    # stream expired/unknown on the replica: abort the
                    # connection mid-chunk (a clean EOF would present a
                    # truncated body as a complete response)
                    raise ConnectionError(
                        f"stream {stream_id} expired on the replica")
                for chunk in chunks:
                    data = _to_bytes(chunk)
                    if data:                 # b"0" ends a chunked body
                        writer.write(b"%x\r\n%s\r\n" % (len(data), data))
                await writer.drain()
                if done:
                    break
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            finished = True
        except BaseException:
            # client gone / chunk failure: release the replica-side
            # generator rather than leaking it in Replica._streams
            try:
                replica.cancel_stream.remote(stream_id)
            except Exception:
                pass
            if isinstance(writer.transport, asyncio.Transport):
                writer.transport.abort()
        return finished

    async def _aget(self, ref, timeout: float = 300.0, pool=None):
        """Await an ObjectRef on a bounded thread pool — NOT via
        ref.future(), which spawns one OS thread per call."""
        import ray_tpu_torch
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            pool or self._pool,
            lambda: ray_tpu_torch.get(ref, timeout=timeout))


def _to_bytes(chunk) -> bytes:
    if isinstance(chunk, bytes):
        return chunk
    if isinstance(chunk, str):
        return chunk.encode()
    return json.dumps(chunk).encode()

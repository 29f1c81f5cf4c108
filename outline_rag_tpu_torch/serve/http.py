"""Minimal asyncio HTTP/1.1 framework.

Replaces the reference's FastAPI + Starlette + uvicorn dependency stack
(reference ``app/main.py:141-173``) with a first-party server sized to this
framework's needs:

- routing with ``{param}`` path segments,
- JSON / form / multipart request bodies with a size cap,
- cookies and HMAC-signed cookie sessions (7-day expiry semantics of the
  reference's ``SessionMiddleware``, reference ``app/main.py:157-164``),
- proxy-header awareness (``X-Forwarded-Proto/For``, reference
  ``app/main.py:154-156``),
- streaming responses (SSE) with chunked transfer encoding,
- static file mounts,
- a global exception handler returning JSON 500s (reference
  ``app/main.py:183-188``),
- an in-process TestClient (SURVEY.md section 4: SSE-consuming fake client).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import json
import logging
import mimetypes
import os
import re
import time
import urllib.parse
from typing import Any, AsyncIterator, Awaitable, Callable

log = logging.getLogger(__name__)

MAX_BODY = 20 * 1024 * 1024
MAX_HEADER = 64 * 1024


# ---------------------------------------------------------------------------
# Sessions: HMAC-signed cookie (itsdangerous-style payload.sig)
# ---------------------------------------------------------------------------


def _b64e(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def _b64d(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def sign_session(secret: str, data: dict, max_age: int) -> str:
    payload = dict(data)
    payload["_exp"] = int(time.time()) + max_age
    raw = _b64e(json.dumps(payload, separators=(",", ":")).encode())
    sig = _b64e(hmac.new(secret.encode(), raw.encode(), hashlib.sha256).digest())
    return f"{raw}.{sig}"


def verify_session(secret: str, token: str) -> dict:
    try:
        raw, sig = token.rsplit(".", 1)
        expected = _b64e(
            hmac.new(secret.encode(), raw.encode(), hashlib.sha256).digest()
        )
        if not hmac.compare_digest(expected, sig):
            return {}
        payload = json.loads(_b64d(raw))
        if payload.get("_exp", 0) < time.time():
            return {}
        payload.pop("_exp", None)
        return payload
    except Exception:
        return {}


# ---------------------------------------------------------------------------
# Request / Response
# ---------------------------------------------------------------------------


class Request:
    def __init__(
        self,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes = b"",
        client: tuple[str, int] | None = None,
    ):
        self.method = method.upper()
        parsed = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(parsed.path)
        self.query = {
            k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()
        }
        self.headers = headers  # lower-cased keys
        self.body = body
        self.client = client or ("127.0.0.1", 0)
        self.path_params: dict[str, str] = {}
        self.session: dict[str, Any] = {}
        self._session_loaded: dict[str, Any] = {}
        self.app: "App | None" = None

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body)

    @property
    def cookies(self) -> dict[str, str]:
        out: dict[str, str] = {}
        raw = self.headers.get("cookie", "")
        for part in raw.split(";"):
            if "=" in part:
                k, v = part.split("=", 1)
                out[k.strip()] = urllib.parse.unquote(v.strip())
        return out

    @property
    def scheme(self) -> str:
        return self.headers.get("x-forwarded-proto", "http")

    @property
    def remote_addr(self) -> str:
        fwd = self.headers.get("x-forwarded-for")
        if fwd:
            return fwd.split(",")[0].strip()
        return self.client[0]

    def form(self) -> dict[str, str]:
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            return {
                k: v[0]
                for k, v in urllib.parse.parse_qs(self.body.decode()).items()
            }
        return {}

    def multipart(self) -> list[dict]:
        """Parse multipart/form-data; returns
        [{"name", "filename", "content_type", "data"}]."""
        ctype = self.headers.get("content-type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m or not ctype.startswith("multipart/form-data"):
            return []
        boundary = b"--" + m.group(1).encode()
        parts = []
        for raw in self.body.split(boundary)[1:-1]:
            raw = raw.strip(b"\r\n")
            if not raw or raw == b"--":
                continue
            if b"\r\n\r\n" in raw:
                head, data = raw.split(b"\r\n\r\n", 1)
            else:
                head, data = raw, b""
            item = {"name": "", "filename": None, "content_type": "", "data": data}
            for line in head.decode(errors="replace").split("\r\n"):
                lk = line.lower()
                if lk.startswith("content-disposition"):
                    nm = re.search(r'name="([^"]*)"', line)
                    fn = re.search(r'filename="([^"]*)"', line)
                    if nm:
                        item["name"] = nm.group(1)
                    if fn:
                        item["filename"] = fn.group(1)
                elif lk.startswith("content-type:"):
                    item["content_type"] = line.split(":", 1)[1].strip()
            parts.append(item)
        return parts


class Response:
    def __init__(
        self,
        body: bytes | str = b"",
        status: int = 200,
        headers: dict[str, str] | None = None,
        content_type: str = "text/plain; charset=utf-8",
    ):
        self.status = status
        self.headers = dict(headers or {})
        self.body = body.encode() if isinstance(body, str) else body
        self.stream: AsyncIterator[bytes] | None = None
        self.headers.setdefault("content-type", content_type)
        self._cookies: list[str] = []

    @classmethod
    def json(cls, data: Any, status: int = 200, headers=None) -> "Response":
        return cls(
            json.dumps(data, ensure_ascii=False),
            status,
            headers,
            content_type="application/json",
        )

    @classmethod
    def redirect(cls, location: str, status: int = 302) -> "Response":
        return cls(b"", status, {"location": location})

    @classmethod
    def streaming(
        cls,
        gen: AsyncIterator[bytes],
        content_type: str = "text/event-stream",
        headers: dict[str, str] | None = None,
        status: int = 200,
    ) -> "Response":
        resp = cls(b"", status, headers, content_type=content_type)
        resp.stream = gen
        resp.headers.setdefault("cache-control", "no-cache")
        return resp

    def set_cookie(
        self,
        name: str,
        value: str,
        max_age: int | None = None,
        path: str = "/",
        http_only: bool = True,
        same_site: str = "Lax",
        secure: bool = False,
    ) -> None:
        parts = [f"{name}={urllib.parse.quote(value)}", f"Path={path}"]
        if max_age is not None:
            parts.append(f"Max-Age={max_age}")
        if http_only:
            parts.append("HttpOnly")
        if same_site:
            parts.append(f"SameSite={same_site}")
        if secure:
            parts.append("Secure")
        self._cookies.append("; ".join(parts))

    def delete_cookie(self, name: str, path: str = "/") -> None:
        self._cookies.append(f"{name}=; Path={path}; Max-Age=0")


Handler = Callable[[Request], Awaitable[Response]]


# ---------------------------------------------------------------------------
# App / routing
# ---------------------------------------------------------------------------


def _compile_pattern(path: str) -> re.Pattern:
    regex = ""
    for seg in re.split(r"(\{[a-zA-Z_][a-zA-Z0-9_]*\})", path):
        if seg.startswith("{") and seg.endswith("}"):
            regex += f"(?P<{seg[1:-1]}>[^/]+)"
        else:
            regex += re.escape(seg)
    return re.compile("^" + regex + "$")


class App:
    def __init__(self, secret_key: str = "", session_max_age: int = 7 * 24 * 3600):
        self.routes: list[tuple[str, re.Pattern, Handler]] = []
        self.static_mounts: list[tuple[str, str]] = []
        self.secret_key = secret_key
        self.session_max_age = session_max_age
        self.session_cookie = "session"
        self.state: dict[str, Any] = {}
        self.on_startup: list[Callable[[], Awaitable[None]]] = []
        self.on_shutdown: list[Callable[[], Awaitable[None]]] = []
        self._bg: list[asyncio.Task] = []

    def route(self, method: str, path: str):
        pattern = _compile_pattern(path)

        def deco(fn: Handler) -> Handler:
            self.routes.append((method.upper(), pattern, fn))
            return fn

        return deco

    def get(self, path: str):
        return self.route("GET", path)

    def post(self, path: str):
        return self.route("POST", path)

    def put(self, path: str):
        return self.route("PUT", path)

    def delete(self, path: str):
        return self.route("DELETE", path)

    def mount_static(self, prefix: str, directory: str) -> None:
        self.static_mounts.append((prefix.rstrip("/"), directory))

    def spawn(self, coro) -> asyncio.Task:
        task = asyncio.create_task(coro)
        self._bg.append(task)
        return task

    async def startup(self) -> None:
        for fn in self.on_startup:
            await fn()

    async def shutdown(self) -> None:
        for task in self._bg:
            task.cancel()
        for task in self._bg:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        for fn in self.on_shutdown:
            await fn()

    # -- request dispatch ----------------------------------------------

    async def handle(self, req: Request) -> Response:
        from outline_rag_tpu_torch.utils.logging import request_id_var
        from outline_rag_tpu_torch.utils.profiling import metrics

        req.app = self
        request_id_var.set(os.urandom(4).hex())
        if self.secret_key:
            token = req.cookies.get(self.session_cookie, "")
            req.session = verify_session(self.secret_key, token) if token else {}
            req._session_loaded = dict(req.session)
        t0 = time.perf_counter()
        try:
            resp = await self._dispatch(req)
        except Exception:
            log.exception("unhandled error on %s %s", req.method, req.path)
            resp = Response.json({"error": "internal server error"}, 500)
        finally:
            metrics.record(f"http.{req.method}", time.perf_counter() - t0)
        if self.secret_key and req.session != req._session_loaded:
            if req.session:
                resp.set_cookie(
                    self.session_cookie,
                    sign_session(self.secret_key, req.session, self.session_max_age),
                    max_age=self.session_max_age,
                    secure=req.scheme == "https",
                )
            else:
                resp.delete_cookie(self.session_cookie)
        return resp

    async def _dispatch(self, req: Request) -> Response:
        for prefix, directory in self.static_mounts:
            if req.path.startswith(prefix + "/") and req.method == "GET":
                return self._serve_static(directory, req.path[len(prefix) + 1 :])
        allowed: list[str] = []
        for method, pattern, handler in self.routes:
            m = pattern.match(req.path)
            if m:
                if method != req.method:
                    allowed.append(method)
                    continue
                req.path_params = m.groupdict()
                return await handler(req)
        if allowed:
            return Response.json({"error": "method not allowed"}, 405)
        return Response.json({"error": "not found"}, 404)

    def _serve_static(self, directory: str, rel: str) -> Response:
        full = os.path.realpath(os.path.join(directory, rel))
        base = os.path.realpath(directory)
        if not full.startswith(base + os.sep) and full != base:
            return Response.json({"error": "not found"}, 404)
        if not os.path.isfile(full):
            return Response.json({"error": "not found"}, 404)
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            return Response(f.read(), content_type=ctype)


# ---------------------------------------------------------------------------
# asyncio socket server
# ---------------------------------------------------------------------------


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        self.message = message


async def _read_request(reader: asyncio.StreamReader) -> Request | None:
    """None on clean EOF / malformed start; raises _BadRequest for
    protocol violations that deserve an error response."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError:
        return None
    except asyncio.LimitOverrunError as e:
        raise _BadRequest(431, "headers too large") from e
    if len(head) > MAX_HEADER:
        raise _BadRequest(431, "headers too large")
    # native single-pass head parser (C++, the uvloop/httptools
    # equivalent); parity-fuzzed against the Python fallback below
    from outline_rag_tpu_torch.native import parse_request_head_native

    parsed = parse_request_head_native(head)
    if parsed is not None:
        method, target, headers = parsed
    else:
        lines = head.decode("latin1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await _read_chunked_body(reader)
        headers["content-length"] = str(len(body))
        return Request(method, target, headers, body)
    try:
        length = int(headers.get("content-length", 0) or 0)
    except ValueError as e:
        raise _BadRequest(400, "bad content-length") from e
    if length > MAX_BODY:
        raise _BadRequest(413, "payload too large")
    body = await reader.readexactly(length) if length else b""
    return Request(method, target, headers, body)


async def _read_chunked_body(reader: asyncio.StreamReader) -> bytes:
    """Chunked transfer decoding for request bodies (some webhook senders
    and streaming clients use it; the reference's uvicorn accepts it)."""
    chunks: list[bytes] = []
    total = 0
    while True:
        size_line = (await reader.readline()).strip()
        try:
            size = int(size_line.split(b";", 1)[0], 16)
        except ValueError as e:
            raise _BadRequest(400, "bad chunk size") from e
        if size == 0:
            # consume trailer headers up to the blank line
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            return b"".join(chunks)
        total += size
        if total > MAX_BODY:
            raise _BadRequest(413, "payload too large")
        chunks.append(await reader.readexactly(size))
        await reader.readexactly(2)  # trailing CRLF


async def _write_response(
    writer: asyncio.StreamWriter,
    resp: Response,
    keep_alive: bool,
    write_timeout: float | None = None,
) -> bool:
    """Returns whether the connection can be kept alive. ``write_timeout``
    caps each drain so a client that stops reading a stream is reaped."""

    async def drain():
        if write_timeout is None:
            await writer.drain()
        else:
            await asyncio.wait_for(writer.drain(), timeout=write_timeout)

    headers = dict(resp.headers)
    cookies = resp._cookies
    status_line = f"HTTP/1.1 {resp.status} {_REASONS.get(resp.status, 'OK')}\r\n"
    if resp.stream is not None:
        headers["transfer-encoding"] = "chunked"
        headers.pop("content-length", None)
        headers["connection"] = "keep-alive" if keep_alive else "close"
        head = status_line + "".join(
            f"{k}: {v}\r\n" for k, v in headers.items()
        )
        head += "".join(f"set-cookie: {c}\r\n" for c in cookies)
        writer.write((head + "\r\n").encode("latin1"))
        await drain()
        try:
            async for chunk in resp.stream:
                if not chunk:
                    continue
                writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                await drain()
        finally:
            # deterministically close the generator chain on ANY exit
            # (client disconnect included): downstream finallys — e.g.
            # the decode batcher's abandoned-request cancellation —
            # must fire now, not whenever GC finds the suspended frame
            try:
                await resp.stream.aclose()
            except Exception:
                # generator cleanup can do real work (persisting the
                # partial turn) — a failure must at least be visible
                log.exception("stream generator close failed")
            writer.write(b"0\r\n\r\n")
            await drain()
        return keep_alive
    headers["content-length"] = str(len(resp.body))
    headers["connection"] = "keep-alive" if keep_alive else "close"
    head = status_line + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
    head += "".join(f"set-cookie: {c}\r\n" for c in cookies)
    writer.write((head + "\r\n").encode("latin1") + resp.body)
    await drain()
    return keep_alive


_REASONS = {
    200: "OK", 201: "Created", 204: "No Content", 302: "Found",
    304: "Not Modified", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error",
}


class ServerLimits:
    """DoS hygiene knobs (uvicorn-class behavior, reference
    ``app/main.py:141-173`` stack):

    - ``request_timeout``: the ENTIRE request (idle wait + head + body)
      must arrive within this window — a wait_for around the read, so a
      slowloris trickling bytes cannot extend it;
    - ``write_timeout``: per-drain cap, reaps clients that stop reading
      an SSE stream;
    - ``max_connections``: excess connections get an immediate 503;
    - ``max_keepalive_requests``: cap on requests per connection;
    - ``max_streams``: bound on concurrently-open streaming (SSE)
      responses across the server.
    """

    def __init__(
        self,
        request_timeout: float = 60.0,
        write_timeout: float = 30.0,
        max_connections: int = 1024,
        max_keepalive_requests: int = 1000,
        max_streams: int = 256,
    ):
        self.request_timeout = request_timeout
        self.write_timeout = write_timeout
        self.max_connections = max_connections
        self.max_keepalive_requests = max_keepalive_requests
        self.max_streams = max_streams
        self.connections = 0  # live counters
        self.streams = 0
        self.in_flight = 0  # requests being processed (drain watches this,
        # not `connections`: idle keep-alive conns must not stall shutdown)


async def _serve_connection(
    app: App, reader, writer, limits: ServerLimits | None = None
) -> None:
    limits = limits or ServerLimits()
    served = 0
    try:
        while True:
            try:
                req = await asyncio.wait_for(
                    _read_request(reader), timeout=limits.request_timeout
                )
            except asyncio.TimeoutError:
                break  # idle or slow-trickling client: reap silently
            except _BadRequest as e:
                await _write_response(
                    writer, Response.json({"error": e.message}, e.status), False
                )
                break
            if req is None:
                break
            peer = writer.get_extra_info("peername") or ("127.0.0.1", 0)
            req.client = (peer[0], peer[1]) if isinstance(peer, tuple) else peer
            served += 1
            keep = (
                req.headers.get("connection", "keep-alive").lower() != "close"
                and served < limits.max_keepalive_requests
            )
            # in_flight covers the HANDLER too, not just the response
            # write: the SIGTERM drain loop watches this counter, and a
            # request still executing inside app.handle (a slow ingest
            # POST, a to_thread retrieval) must hold the drain window
            # open or shutdown hooks run concurrently with it
            limits.in_flight += 1
            streaming = False
            try:
                resp = await app.handle(req)
                streaming = resp.stream is not None
                if streaming and limits.streams >= limits.max_streams:
                    resp = Response.json({"error": "too many streams"}, 503)
                    streaming = False
                if streaming:
                    limits.streams += 1
                try:
                    ok = await _write_response(
                        writer, resp, keep, write_timeout=limits.write_timeout
                    )
                finally:
                    if streaming:
                        limits.streams -= 1
            finally:
                limits.in_flight -= 1
            if not ok:
                break
    except (
        ConnectionResetError,
        BrokenPipeError,
        asyncio.CancelledError,
        asyncio.TimeoutError,
    ):
        pass
    except Exception:
        log.exception("connection handler error")
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            pass


async def serve(
    app: App,
    host: str,
    port: int,
    limits: ServerLimits | None = None,
) -> asyncio.AbstractServer:
    await app.startup()
    limits = limits or ServerLimits()

    async def on_conn(r, w):
        if limits.connections >= limits.max_connections:
            try:
                w.write(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"content-length: 0\r\nconnection: close\r\n\r\n"
                )
                await w.drain()
                # absorb any already-sent request bytes so close() sends a
                # clean FIN rather than an RST that races the 503
                await asyncio.wait_for(r.read(65536), timeout=0.2)
            except Exception:
                pass
            finally:
                w.close()
            return
        limits.connections += 1
        try:
            await _serve_connection(app, r, w, limits)
        finally:
            limits.connections -= 1

    server = await asyncio.start_server(on_conn, host, port)
    log.info("listening on %s:%d", host, port)
    return server


def run(
    app: App,
    host: str = "0.0.0.0",
    port: int = 8000,
    drain_timeout: float = 10.0,
) -> None:
    """Serve until SIGTERM/SIGINT, then shut down gracefully: stop
    accepting, give in-flight requests (including SSE streams) up to
    ``drain_timeout`` seconds to finish, then run shutdown hooks — the
    behavior uvicorn gives the reference (`app/main.py` stack); without
    a handler, Docker's SIGTERM would kill mid-stream with no cleanup."""
    import os
    import signal

    async def main():
        limits = ServerLimits()
        server = await serve(app, host, port, limits=limits)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()

        def on_signal():
            if stop.is_set():  # second signal: force-quit (uvicorn-like)
                log.warning("second shutdown signal: forcing exit")
                os._exit(130)
            stop.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, on_signal)
            except (NotImplementedError, RuntimeError):
                pass  # non-unix / nested loop: fall back to default
        try:
            await stop.wait()
            server.close()  # stop accepting; in-flight handlers continue
            log.info("shutdown signal: draining %d in-flight request(s)",
                     limits.in_flight)
            deadline = loop.time() + drain_timeout
            # idle keep-alive connections don't count: only requests
            # mid-processing (SSE streams included) hold the window open
            while limits.in_flight > 0 and loop.time() < deadline:
                await asyncio.sleep(0.1)
        finally:
            await app.shutdown()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# In-process test client
# ---------------------------------------------------------------------------


class TestClient:
    """Calls ``app.handle`` directly; maintains a cookie jar; can consume
    SSE streams."""

    __test__ = False  # not a pytest class

    def __init__(self, app: App):
        self.app = app
        self.cookies: dict[str, str] = {}

    def _headers(self, headers: dict[str, str] | None) -> dict[str, str]:
        h = {k.lower(): v for k, v in (headers or {}).items()}
        if self.cookies:
            h["cookie"] = "; ".join(f"{k}={v}" for k, v in self.cookies.items())
        return h

    def _absorb_cookies(self, resp: Response) -> None:
        for c in resp._cookies:
            first = c.split(";", 1)[0]
            if "=" in first:
                k, v = first.split("=", 1)
                if "Max-Age=0" in c:
                    self.cookies.pop(k, None)
                else:
                    self.cookies[k] = urllib.parse.unquote(v)

    async def request(
        self,
        method: str,
        path: str,
        json_body: Any = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
    ) -> Response:
        h = self._headers(headers)
        if json_body is not None:
            body = json.dumps(json_body).encode()
            h["content-type"] = "application/json"
        h["content-length"] = str(len(body))
        req = Request(method, path, h, body)
        resp = await self.app.handle(req)
        self._absorb_cookies(resp)
        if resp.stream is not None:
            chunks = []
            async for chunk in resp.stream:
                chunks.append(chunk)
            resp.body = b"".join(chunks)
        return resp

    async def get(self, path, **kw):
        return await self.request("GET", path, **kw)

    async def post(self, path, **kw):
        return await self.request("POST", path, **kw)

    async def put(self, path, **kw):
        return await self.request("PUT", path, **kw)

    async def delete(self, path, **kw):
        return await self.request("DELETE", path, **kw)

    async def sse_timed(
        self, method: str, path: str, json_body: Any = None
    ) -> tuple[list[dict | str], float, float]:
        """Like :meth:`sse` but measures streaming latencies: returns
        ``(events, ttfr_s, total_s)`` where ``ttfr_s`` is time to the
        first real ``data:`` frame (for the ask path: classifier +
        rewrite + retrieval complete, generation starting) and
        ``total_s`` the time to stream end. Benchmark instrumentation
        (the north-star rung reports p50/p95 TTFR)."""
        import time as _time

        t0 = _time.perf_counter()
        h = self._headers(None)
        body = b""
        if json_body is not None:
            body = json.dumps(json_body).encode()
            h["content-type"] = "application/json"
        h["content-length"] = str(len(body))
        req = Request(method, path, h, body)
        resp = await self.app.handle(req)
        self._absorb_cookies(resp)
        t_first = None
        if resp.stream is not None:
            chunks = []
            async for chunk in resp.stream:
                if t_first is None and b"data:" in chunk:
                    t_first = _time.perf_counter() - t0
                chunks.append(chunk)
            resp.body = b"".join(chunks)
        total = _time.perf_counter() - t0
        if t_first is None:
            t_first = total
        return self._parse_sse(resp.body), t_first, total

    @staticmethod
    def _parse_sse(body: bytes, max_events: int = 1000) -> list[dict | str]:
        events: list[dict | str] = []
        for frame in body.decode().split("\n\n"):
            frame = frame.strip()
            if not frame:
                continue
            if frame.startswith(":"):
                events.append("ping")
                continue
            for line in frame.split("\n"):
                if line.startswith("data:"):
                    payload = line[5:].strip()
                    if payload == "[DONE]":
                        events.append("[DONE]")
                    else:
                        try:
                            events.append(json.loads(payload))
                        except json.JSONDecodeError:
                            events.append(payload)
            if len(events) >= max_events:
                break
        return events

    async def sse(
        self, method: str, path: str, json_body: Any = None, max_events: int = 1000
    ) -> list[dict | str]:
        """POST and parse the SSE stream into a list of ``data:`` payloads
        (JSON-decoded when possible); pings appear as ``"ping"``."""
        resp = await self.request(method, path, json_body=json_body)
        return self._parse_sse(resp.body, max_events)

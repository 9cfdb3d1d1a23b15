"""BlobStore: S3-style object store endpoint + HTTP client with rate control.

The port's own copy of the reference package's ``fileio/blobstore.py``.

Ref: fdbrpc/BlobStore.h:34 (`BlobStoreEndpoint` — blobstore:// URLs, bucket
object CRUD, requests/sec + bytes/sec throttles, retries) and
fdbrpc/HTTP.actor.cpp (the hand-rolled HTTP/1.1 client it rides).  The
rebuild keeps the same layering: a small HTTP/1.1 codec, a socket client
with token-bucket rate control and bounded retries, and an endpoint
offering put/get/delete/list.  `BlobStoreServer` is the in-repo test
double (the reference talks to real S3; backup tests here need a live
target on localhost, like the real-transport suite spawns real sockets).

Determinism note: this is a REAL-deployment component (sockets + wall
clock).  Calls from simulation tests run blocking-synchronously between
virtual-time steps, so the sim's event interleaving is unaffected.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, quote, unquote, urlparse

from ..flow.error import FdbError

MAX_OBJECT_BYTES = 1 << 30


# --------------------------------------------------------------------------
# HTTP/1.1 codec (the HTTP.actor.cpp analog: just what an object store needs)
# --------------------------------------------------------------------------


def build_request(method: str, path: str, headers: Dict[str, str],
                  body: bytes = b"") -> bytes:
    lines = [f"{method} {path} HTTP/1.1"]
    h = dict(headers)
    h.setdefault("Content-Length", str(len(body)))
    h.setdefault("Connection", "keep-alive")
    for k, v in h.items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def _recv_until(sock: socket.socket, buf: bytearray, marker: bytes) -> int:
    while marker not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed mid-response")
        buf.extend(chunk)
    return buf.index(marker)


def read_response(sock: socket.socket) -> Tuple[int, Dict[str, str], bytes]:
    """(status, headers, body); Content-Length framing only (the test
    double never chunks)."""
    buf = bytearray()
    head_end = _recv_until(sock, buf, b"\r\n\r\n")
    head = bytes(buf[:head_end]).decode("latin-1")
    rest = bytearray(buf[head_end + 4:])
    lines = head.split("\r\n")
    parts = lines[0].split(" ", 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/"):
        raise FdbError("http_bad_response")
    try:
        status = int(parts[1])
    except ValueError:
        # A garbage status line must surface as the codec's own error,
        # not a ValueError escaping the error model (and the caller
        # drops the now-desynced connection before retrying).
        raise FdbError("http_bad_response") from None
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    try:
        n = int(headers.get("content-length", "0"))
    except ValueError:
        raise FdbError("http_bad_response") from None
    if n < 0 or n > MAX_OBJECT_BYTES:
        raise FdbError("http_bad_response")
    while len(rest) < n:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed mid-body")
        rest.extend(chunk)
    return status, headers, bytes(rest[:n])


def parse_request(data: bytes) -> Optional[Tuple[str, str, Dict[str, str], bytes, int]]:
    """(method, path, headers, body, consumed), None if incomplete, or
    ValueError on a malformed request (bad request line / content-length)
    — servers answer 400 and close."""
    idx = data.find(b"\r\n\r\n")
    if idx < 0:
        return None
    head = data[:idx].decode("latin-1")
    lines = head.split("\r\n")
    req_parts = lines[0].split(" ", 2)
    if len(req_parts) != 3:
        raise ValueError("malformed request line")
    method, path, _ver = req_parts
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0"))  # ValueError -> 400
    if n < 0 or n > MAX_OBJECT_BYTES:
        raise ValueError("bad content-length")
    total = idx + 4 + n
    if len(data) < total:
        return None
    return method, path, headers, data[idx + 4: total], total


def build_response(status: int, body: bytes = b"",
                   headers: Optional[Dict[str, str]] = None) -> bytes:
    reason = {200: "OK", 204: "No Content", 404: "Not Found",
              400: "Bad Request", 500: "Internal Server Error"}.get(status, "X")
    h = {"Content-Length": str(len(body)), "Connection": "keep-alive"}
    h.update(headers or {})
    head = f"HTTP/1.1 {status} {reason}\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in h.items()
    )
    return head.encode() + b"\r\n" + body


# --------------------------------------------------------------------------
# Rate control (ref: BlobStoreEndpoint's requests_per_second +
# bytes-per-second knobs via a token bucket)
# --------------------------------------------------------------------------


class TokenBucket:
    """Token bucket; acquire() blocks until the charge is covered.
    rate=None disables (unlimited).

    Debt model: a charge larger than the burst is granted once the bucket
    is full and drives the balance negative, delaying later acquires —
    so oversized bodies are paced rather than deadlocked (a strict
    'tokens >= n' wait could never be satisfied for n > burst).

    The clock/sleep pair is injectable (tests pace with fake time); the
    default is wall time because rate control meters a REAL network —
    these two lines are the module's only sanctioned wall-clock bindings."""

    def __init__(self, rate: Optional[float], burst: Optional[float] = None,
                 clock=None, sleep=None):
        self.rate = rate
        self.burst = burst if burst is not None else max(rate or 0, 1.0)
        self.tokens = self.burst
        self._clock = clock or time.monotonic  # fdblint: ignore[DET001]: rate control meters the real network; sim tests leave rate=None or inject a fake clock
        self._sleep = sleep or time.sleep  # fdblint: ignore[DET001]: see clock above; injectable for deterministic tests
        self.t = self._clock()
        self._lock = threading.Lock()

    def acquire(self, n: float = 1.0):
        if self.rate is None:
            return
        while True:
            with self._lock:
                now = self._clock()
                self.tokens = min(
                    self.burst, self.tokens + (now - self.t) * self.rate
                )
                self.t = now
                need_tokens = min(n, self.burst)
                if self.tokens >= need_tokens:
                    self.tokens -= n  # may go negative: the debt model
                    return
                need = (need_tokens - self.tokens) / self.rate
            self._sleep(min(need, 0.05))


# --------------------------------------------------------------------------
# Endpoint (ref: BlobStoreEndpoint, fdbrpc/BlobStore.h:34)
# --------------------------------------------------------------------------


class BlobStoreEndpoint:
    """Client for one blob store: blobstore://host:port/bucket with
    optional knobs in the query string (requests_per_second,
    read_bytes_per_second, write_bytes_per_second, retries)."""

    def __init__(self, host: str, port: int, bucket: str,
                 requests_per_second: Optional[float] = None,
                 read_bytes_per_second: Optional[float] = None,
                 write_bytes_per_second: Optional[float] = None,
                 retries: int = 4):
        self.host, self.port, self.bucket = host, port, bucket
        self.retries = retries
        self.req_bucket = TokenBucket(requests_per_second)
        self.read_bucket = TokenBucket(read_bytes_per_second)
        self.write_bucket = TokenBucket(write_bytes_per_second)
        # Injectable retry-backoff sleep (wall by default: it paces real
        # reconnects; tests stub it to run the retry chain instantly).
        self._backoff_sleep = time.sleep  # fdblint: ignore[DET001]: backoff paces real socket reconnects; injectable for tests
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    @classmethod
    def from_url(cls, url: str) -> "BlobStoreEndpoint":
        u = urlparse(url)
        if u.scheme != "blobstore":
            raise ValueError(f"not a blobstore url: {url}")
        q = parse_qs(u.query)

        def knob(name):
            return float(q[name][0]) if name in q else None

        return cls(
            u.hostname or "127.0.0.1",
            u.port or 80,
            u.path.strip("/").split("/")[0] or "backup",
            requests_per_second=knob("requests_per_second"),
            read_bytes_per_second=knob("read_bytes_per_second"),
            write_bytes_per_second=knob("write_bytes_per_second"),
            retries=int(q.get("retries", ["4"])[0]),
        )

    # -- connection management (keep-alive, reconnect on failure) --
    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=30
            )
        return self._sock

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _request(self, method: str, path: str, body: bytes = b""):
        """One request with rate control + bounded retries (ref: the retry
        loop with backoff in BlobStoreEndpoint::doRequest)."""
        self.req_bucket.acquire()
        if method == "PUT":
            self.write_bucket.acquire(max(1, len(body)))
        err = None
        for attempt in range(self.retries + 1):
            failed = False
            with self._lock:
                try:
                    s = self._connect()
                    s.sendall(build_request(
                        method, path, {"Host": self.host}, body
                    ))
                    status, headers, data = read_response(s)
                except (OSError, FdbError) as e:
                    # OSError: connection broke.  FdbError (only
                    # http_bad_response here): the stream is desynced —
                    # a stale keep-alive socket served by a restarted
                    # peer, or a corrupted hop.  Same treatment either
                    # way: drop the socket and retry on a fresh one.
                    self._drop()
                    err = e
                    failed = True
            if failed:
                # Backoff OUTSIDE the lock: other threads' independent
                # requests must not stall behind this one's retry chain.
                self._backoff_sleep(min(0.1 * (2 ** attempt), 2.0))
                continue
            if method == "GET" and data:
                self.read_bucket.acquire(len(data))
            return status, headers, data
        raise FdbError("connection_failed") from err

    # -- object API --
    def _obj_path(self, name: str) -> str:
        return f"/{quote(self.bucket)}/{quote(name, safe='')}"

    def put_object(self, name: str, data: bytes) -> None:
        status, _h, _b = self._request("PUT", self._obj_path(name), data)
        if status != 200:
            raise FdbError("io_error")

    def get_object(self, name: str) -> bytes:
        status, _h, data = self._request("GET", self._obj_path(name))
        if status == 404:
            raise FdbError("file_not_found")
        if status != 200:
            raise FdbError("io_error")
        return data

    def delete_object(self, name: str) -> None:
        status, _h, _b = self._request("DELETE", self._obj_path(name))
        if status not in (200, 204, 404):
            raise FdbError("io_error")

    def object_exists(self, name: str) -> bool:
        """HEAD — existence costs O(1), not a body download charged
        against the read budget."""
        status, _h, _b = self._request("HEAD", self._obj_path(name))
        if status == 404:
            return False
        if status != 200:
            raise FdbError("io_error")
        return True

    def list_objects(self, prefix: str = "") -> List[str]:
        status, _h, data = self._request(
            "GET", f"/{quote(self.bucket)}?prefix={quote(prefix, safe='')}"
        )
        if status != 200:
            raise FdbError("io_error")
        return [unquote(n) for n in data.decode().split("\n") if n]

    def close(self):
        self._drop()


# --------------------------------------------------------------------------
# Test-double server (S3 stand-in on localhost; memory-backed)
# --------------------------------------------------------------------------


class BlobStoreServer:
    """Minimal object-store server: PUT/GET/DELETE /bucket/object and
    GET /bucket?prefix= listing.  Threaded blocking sockets; keep-alive."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.objects: Dict[Tuple[str, str], bytes] = {}
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    @property
    def url(self) -> str:
        return f"blobstore://{self.host}:{self.port}/backup"

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def kick_connections(self):
        """Close every live connection (keep-alive breakage injection for
        the client's reconnect path)."""
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass
        self._conns.clear()

    def _serve_conn(self, conn: socket.socket):
        self._conns.append(conn)
        buf = bytearray()
        try:
            while not self._stop:
                parsed = parse_request(bytes(buf))
                if parsed is None:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf.extend(chunk)
                    continue
                method, path, _headers, body, consumed = parsed
                del buf[:consumed]
                conn.sendall(self._handle(method, path, body))
        except ValueError:
            # Malformed request: answer 400 and close (a real server's
            # behavior; silently dying desyncs pipelined clients).  The
            # response must SAY close — promising keep-alive on a socket
            # about to shut would strand the next pipelined request.
            try:
                conn.sendall(
                    build_response(400, headers={"Connection": "close"})
                )
            except OSError:
                pass
        except OSError:
            pass
        finally:
            conn.close()

    def _handle(self, method: str, path: str, body: bytes) -> bytes:
        u = urlparse(path)
        parts = [p for p in u.path.split("/") if p]
        if not parts:
            return build_response(400)
        bucket = unquote(parts[0])
        if len(parts) == 1:
            if method != "GET":
                return build_response(400)
            prefix = unquote(parse_qs(u.query).get("prefix", [""])[0])
            with self._lock:
                names = sorted(
                    n for (b, n) in self.objects
                    if b == bucket and n.startswith(prefix)
                )
            return build_response(
                200, "\n".join(quote(n, safe="") for n in names).encode()
            )
        name = unquote(parts[1])
        key = (bucket, name)
        if method == "PUT":
            with self._lock:
                self.objects[key] = body
            return build_response(200)
        if method == "HEAD":
            with self._lock:
                data = self.objects.get(key)
            if data is None:
                return build_response(404)
            # Status + Content-Length, no body (HEAD semantics; the
            # client frames on the header so body must be empty AND the
            # advertised length must be 0 to keep keep-alive in sync).
            return build_response(200)
        if method == "GET":
            with self._lock:
                data = self.objects.get(key)
            if data is None:
                return build_response(404)
            return build_response(200, data)
        if method == "DELETE":
            with self._lock:
                self.objects.pop(key, None)
            return build_response(204)
        return build_response(400)

    def close(self):
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass

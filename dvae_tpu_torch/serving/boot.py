"""Boot-phase instrumentation and early port bind for the serving CLI
(port of ``dvae_tpu.serving.boot``).

* :class:`BootTimer`: a wall-clock phase ledger anchored at the process
  start (``/proc/self/stat`` starttime), so interpreter and import time
  are visible, not just time since ``main``.
* :func:`bind_boot_server`: binds the listening socket with a stdlib-only
  handler before any heavy import or device touch, so a readiness probe
  sees ``{"status": "booting", ...}`` within about a second of exec; every
  other request answers 503 + Retry-After until :func:`attach_service`
  swaps in the real handler (the same ``ThreadingHTTPServer`` keeps the
  socket; per-connection handler classes make the swap safe).

This module imports only the standard library: binding cannot wait for
torch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def process_start_time() -> float:
    """POSIX wall-clock time this process was exec'd, from /proc/self/stat
    starttime + /proc/stat btime. Falls back to ``time.time()`` off Linux
    (phase durations stay right; the interpreter segment collapses to 0)."""
    try:
        with open("/proc/self/stat", "rb") as f:
            # starttime is field 22; split after the parenthesised comm,
            # which may itself contain spaces
            after_comm = f.read().rsplit(b") ", 1)[1].split()
        ticks = int(after_comm[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime "))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except Exception:
        return time.time()


class BootTimer:
    """Thread-safe named-phase ledger; phases may overlap."""

    def __init__(self):
        self.t0 = process_start_time()
        self._lock = threading.Lock()
        self._phases: dict[str, list] = {}   # name -> [start, end|None]
        self._marks: dict[str, float] = {}
        self.mark("interpreter_start", at=self.t0)

    def mark(self, name: str, at: float | None = None) -> None:
        with self._lock:
            self._marks[name] = (at if at is not None else time.time())

    def mark_once(self, name: str) -> bool:
        """Atomic mark-if-absent: two racing markers cannot overwrite an
        earlier mark with a later time. True iff this call placed it."""
        with self._lock:
            if name in self._marks:
                return False
            self._marks[name] = time.time()
            return True

    def start(self, name: str) -> None:
        with self._lock:
            self._phases[name] = [time.time(), None]

    def end(self, name: str) -> None:
        with self._lock:
            if name in self._phases:
                self._phases[name][1] = time.time()

    @contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.end(name)

    def snapshot(self) -> dict:
        """JSON-ready view: per-phase {start_s, dur_s} relative to process
        start, marks as offsets, open phases listed as ``in_progress``."""
        now = time.time()
        with self._lock:
            phases = {
                n: {"start_s": round(s - self.t0, 2),
                    "dur_s": round((e if e is not None else now) - s, 2),
                    **({} if e is not None else {"running": True})}
                for n, (s, e) in self._phases.items()
            }
            marks = {n: round(t - self.t0, 2)
                     for n, t in self._marks.items() if n != "interpreter_start"}
            current = [n for n, (s, e) in self._phases.items() if e is None]
        return {"phases": phases, "marks": marks, "in_progress": current,
                "elapsed_s": round(now - self.t0, 2)}


class ServingHTTPServer(ThreadingHTTPServer):
    """The server class of both the boot bind and ``http.make_server``.

    Non-daemon handler threads: ``server_close()`` joins them, so exit
    after a drain cannot truncate a response still being written. A listen
    backlog of 128: socketserver's default of 5 drops the connection
    requests of a burst of concurrent clients beyond it, and the kernel
    only retries them after 1 s (3 s on the second try), far outside a
    micro-batch window."""

    daemon_threads = False
    request_queue_size = 128


class _BootHandler(BaseHTTPRequestHandler):
    """Answers for the server between bind and :func:`attach_service`."""

    boot: BootTimer = None  # injected by bind_boot_server
    protocol_version = "HTTP/1.1"
    timeout = 65

    def log_message(self, fmt, *args):  # quiet (matches RequestHandler)
        pass

    def _json(self, code: int, obj, retry: bool = False) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry:
            self.send_header("Retry-After", "2")
        # request bodies are never read here: the connection must close, or
        # keep-alive would parse the unread body as the next request, and
        # the client must be told so
        self.close_connection = True
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.split("?", 1)[0] == "/healthz":
            self._json(200, {"status": "booting", "ready": False,
                             "boot": self.boot.snapshot()})
        else:
            self._json(503, {"error": "server is booting",
                             "boot": self.boot.snapshot()}, retry=True)

    def do_POST(self):
        self._json(503, {"error": "server is booting; retry shortly"}, retry=True)


def bind_boot_server(host: str, port: int, boot: BootTimer) -> ServingHTTPServer:
    """Bind the listening socket now with the boot handler and accept
    connections on a daemon thread. The returned server is the one,
    permanent server; :func:`attach_service` later swaps its handler class
    in place (the caller joins ``server._serve_thread`` at the end)."""
    handler = type("BoundBootHandler", (_BootHandler,), {"boot": boot})
    server = ServingHTTPServer((host, port), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True, name="serve-http")
    t.start()
    server._serve_thread = t
    boot.mark("port_bound")
    return server


def attach_service(server: ServingHTTPServer, service, verbose: bool = False,
                   admin_token: str | None = None) -> None:
    """Swap the real request handler onto the already-listening server.
    Imported lazily: ``serving.http`` pulls in torch. Connections accepted
    after this line get the service."""
    from dvae_tpu_torch.serving.http import bound_handler

    server.RequestHandlerClass = bound_handler(service, verbose, admin_token)

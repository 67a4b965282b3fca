"""The HTTP layer of the serving package (port of ``dvae_tpu.serving.http``,
with the same routes, status codes and headers): request parsing and
validation, status-code mapping, streamed responses, keep-alive hygiene.
Enhancement is delegated to :class:`EnhanceService`; handler threads touch
only numpy and bytes."""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

import numpy as np

from dvae_tpu_torch.data.io import resample
from dvae_tpu_torch.serving.boot import ServingHTTPServer
from dvae_tpu_torch.serving.metrics import _prometheus_text
from dvae_tpu_torch.serving.service import EnhanceService
from dvae_tpu_torch.serving.types import EnhancementError, ServiceOverloaded
from dvae_tpu_torch.serving.wire import (
    _parse_wav_bytes,
    _pcm_seg_bytes,
    _pcm_to_float_mono,
    _riff_header,
    _riff_stream_info,
    _wav_bytes,
)


def platform_of(device) -> str:
    """The platform name /healthz reports, as JAX names it: ``gpu`` for a
    CUDA device, else ``cpu``."""
    return "gpu" if device.type == "cuda" else "cpu"


class RequestHandler(BaseHTTPRequestHandler):
    """Bound to a service by :func:`bound_handler` (class attributes)."""

    service: EnhanceService = None
    admin_token: str | None = None  # gates /reload
    max_content_length = 256 * 1024 * 1024
    protocol_version = "HTTP/1.1"
    # per-recv socket timeout: bounds how long an idle keep-alive connection
    # or a stalled client holds its handler thread (server_close joins them)
    timeout = 65

    def log_message(self, fmt, *args):  # quiet unless bound verbose
        pass

    def _send(self, code: int, body: bytes, ctype: str, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        if self.close_connection:
            # paths that set the flag themselves must say so, or an HTTP/1.1
            # client writes its next request into a closing connection
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj, headers=()):
        self._send(code, json.dumps(obj).encode(), "application/json", headers)

    def _body_length(self):
        """Parsed Content-Length, or None after answering an error. Chunked
        uploads get 411: this server never reads chunked framing, and the
        frames left in the socket would parse as the next request."""
        if self.headers.get("Transfer-Encoding"):
            self._reject_unread(411, {"error": "Transfer-Encoding not supported; send a "
                                               "Content-Length body"})
            return None
        raw = self.headers.get("Content-Length", 0)
        try:
            return int(raw)
        except (TypeError, ValueError):
            self.close_connection = True
            self._json(400, {"error": f"bad Content-Length {raw!r}"})
            return None

    def _reject_unread(self, code: int, obj, headers=()):
        """Error response without having consumed the request body: the
        connection closes (the unread bytes would parse as the next
        request), after a short bounded drain that keeps the kernel from
        answering the client's upload with RST, which would discard the
        response."""
        self.close_connection = True
        self._json(code, obj, headers)
        try:
            self.wfile.flush()
            self.connection.settimeout(1.0)
            remaining = min(int(self.headers.get("Content-Length") or 0), 1 << 20)
            while remaining > 0:
                got = self.rfile.read(min(65536, remaining))
                if not got:
                    break
                remaining -= len(got)
        except Exception:
            pass  # best effort; the response was already sent

    def do_GET(self):
        svc = self.service
        path = urlparse(self.path).path
        if path == "/healthz":
            ready = svc.ready.is_set()
            body = {
                "status": ("ok" if ready else "warmup failed"
                           if svc.warmup_error is not None else "warming"),
                "ready": ready,
                "model_class": svc.model_class,
                "platform": platform_of(svc.device),
                "warm_buckets": svc.warm_buckets,
                "checkpoint": svc.checkpoint,
                "uptime_seconds": round(time.time() - svc.started, 1),
            }
            if svc.warmup_error is not None:
                body["warmup_error"] = str(svc.warmup_error)
            boot = getattr(svc, "boot", None)
            if boot is not None:
                # the boot-phase ledger (serving/boot.py), kept after boot
                body["boot"] = boot.snapshot()
            self._json(200, body)
        elif path == "/stats":
            self._json(200, svc.stats_snapshot())
        elif path == "/metrics":
            self._send(200, _prometheus_text(svc).encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        else:
            self._json(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        svc = self.service
        url = urlparse(self.path)
        length = self._body_length()
        if length is None:
            return
        if url.path == "/reload":
            if length:  # a stray body must not desync the connection
                self.close_connection = True
            q = parse_qs(url.query)
            if self.admin_token is not None and q.get("token", [None])[0] != self.admin_token:
                self._json(403, {"error": "reload requires ?token= (the server's "
                                          "--admin-token)"})
                return
            path = q.get("checkpoint", [None])[0]
            if not path:
                self._json(400, {"error": "pass ?checkpoint=<path> (a .pt state_dict)"})
                return
            try:
                svc.reload_checkpoint(path)
            except (RuntimeError, TimeoutError) as e:
                self._json(503, {"error": str(e)}, headers=(("Retry-After", "1"),))
                return
            except Exception as e:
                self._json(400, {"error": f"reload failed: {e}"})
                return
            self._json(200, {"status": "reloaded", "checkpoint": path})
            return
        if url.path != "/enhance":
            self._reject_unread(404, {"error": f"unknown path {url.path}"})
            return
        q = parse_qs(url.query)
        want = q.get("return", ["speech"])[0]
        if want not in ("speech", "noise", "stereo"):
            self._reject_unread(400, {"error": f"bad return={want!r}"})
            return
        y_source = q.get("y_source", [None])[0]
        if length <= 0:
            self._json(400, {"error": "empty body (POST a RIFF/WAVE file)"})
            return
        if length > self.max_content_length:
            self._reject_unread(413, {"error": "request too large"})
            return
        stream = q.get("stream", ["0"])[0] in ("1", "true")
        model_fs = svc.enh_cfg.stft.fs
        prefix = b""
        if stream and svc.cfg.chunk_seconds > 0:
            # full-duplex fast path: parse only the RIFF prefix; a model-rate
            # PCM body is decoded and enhanced while it uploads, anything
            # else is buffered first
            prefix, info = _riff_stream_info(self.rfile, length)
            if info is not None and info["fs"] == model_fs:
                self._stream_duplex(info, length - len(prefix), y_source, want, model_fs)
                return
        body = prefix + self.rfile.read(length - len(prefix))
        try:
            wav, fs = _parse_wav_bytes(body)
        except Exception as e:
            self._json(400, {"error": f"cannot parse wav: {e}"})
            return
        if fs != model_fs:
            if q.get("resample", ["0"])[0] not in ("1", "true"):
                self._json(400, {"error": f"{fs} Hz != model rate {model_fs} Hz (pass "
                                          "?resample=1 to convert; the response stays at "
                                          "the model rate)"})
                return
            wav = resample(wav, fs, model_fs)
        if stream:
            self._stream_enhance(wav.astype(np.float32), y_source, want, model_fs)
            return
        try:
            s, n = svc.submit(wav.astype(np.float32), y_source)
        except Exception as e:
            self._enhance_error(e)
            return
        chans = {"speech": [s], "noise": [n], "stereo": [s, n]}[want]
        self._send(200, _wav_bytes(chans, model_fs), "audio/wav")

    def _enhance_error(self, e: Exception) -> None:
        """Map an enhancement failure to its wire code: overload (refused at
        admission, or gave up waiting) -> 503 + Retry-After; invalid client
        input -> 400; worker faults -> 500."""
        if isinstance(e, (ServiceOverloaded, TimeoutError)):
            self._json(503, {"error": str(e)}, headers=(("Retry-After", "1"),))
        elif isinstance(e, ValueError):
            self._json(400, {"error": str(e)})
        elif isinstance(e, EnhancementError):  # already prefixed
            self._json(500, {"error": str(e)})
        else:
            self._json(500, {"error": f"enhancement failed: {e}"})

    def _stream_enhance(self, wav: np.ndarray, y_source: str | None, want: str,
                        model_fs: int) -> None:
        """``?stream=1`` with a fully buffered body: stream the response as
        chunks finalize."""
        try:
            gen = self.service.submit_stream(wav, y_source)
        except Exception as e:
            self._enhance_error(e)
            return
        self._stream_response(gen, len(wav), want, model_fs)

    def _stream_duplex(self, info: dict, body_remaining: int, y_source: str | None,
                       want: str, model_fs: int) -> None:
        """``?stream=1`` on a model-rate PCM body: full duplex. The body is
        decoded and fed to the service as it arrives, so device work on
        early chunks overlaps the upload of the tail, and the response
        streams back while the body is still being received. Failures
        before the stream starts close the connection (the body was not
        consumed); on success trailer bytes after the audio are drained so
        keep-alive stays in sync."""
        svc = self.service
        block_align = info["channels"] * info["bits"] // 8
        n_samples = min(info["data_bytes"], body_remaining) // block_align
        audio_bytes = n_samples * block_align
        consumed = [0]

        def blocks():
            pend = b""
            while consumed[0] < audio_bytes:
                # read1: whatever the socket has, so a slow uploader's
                # samples move on as they arrive
                raw = self.rfile.read1(min(65536, audio_bytes - consumed[0]))
                if not raw:
                    raise ValueError("request body ended early")
                consumed[0] += len(raw)
                pend += raw
                cut = len(pend) // block_align * block_align
                if cut == 0:
                    continue  # mid-frame: wait for the rest of the sample
                chunk, pend = pend[:cut], pend[cut:]
                yield _pcm_to_float_mono(chunk, info["fmt"], info["bits"], info["channels"])

        try:
            gen = svc.submit_stream_from(blocks(), n_samples, y_source)
        except Exception as e:
            self.close_connection = True  # body unread
            self._enhance_error(e)
            return
        if self._stream_response(gen, n_samples, want, model_fs, pre_error_close=True):
            left = body_remaining - consumed[0]
            while left > 0:  # drain the trailer for keep-alive sync
                got = self.rfile.read(min(65536, left))
                if not got:
                    self.close_connection = True
                    break
                left -= len(got)

    def _stream_response(self, gen, n_samples: int, want: str, model_fs: int,
                         pre_error_close: bool = False) -> bool:
        """Write one ``?stream=1`` response from a (s_seg, n_seg) generator;
        True when the full body was delivered. The output length is known
        up front, so the response is a standard wav with an exact
        Content-Length. Errors before the first segment map to their status
        codes; after it the only correct signal is a short body and a
        closed connection."""
        try:
            first = next(gen)
        except Exception as e:
            if pre_error_close:  # duplex: the request body was not consumed
                self.close_connection = True
            self._enhance_error(e)
            return False
        n_ch = 2 if want == "stereo" else 1
        data_bytes = 2 * n_ch * n_samples
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(44 + data_bytes))
        self.end_headers()
        try:
            self.wfile.write(_riff_header(data_bytes, n_ch, model_fs))
            self.wfile.write(_pcm_seg_bytes(first, want))
            self.wfile.flush()   # first audio leaves now
            for seg in gen:
                self.wfile.write(_pcm_seg_bytes(seg, want))
                self.wfile.flush()
            return True
        except Exception:
            # device fault mid-request or the client went away: the
            # committed 200 cannot be amended, so truncate and close
            self.close_connection = True
            return False
        finally:
            gen.close()          # abandons any chunks not yet served


def bound_handler(service: EnhanceService, verbose: bool = False,
                  admin_token: str | None = None) -> type:
    """The RequestHandler subclass bound to ``service``, shared by
    :func:`make_server` and the early-bind boot path
    (``serving.boot.attach_service``)."""
    handler = type("BoundHandler", (RequestHandler,),
                   {"service": service, "admin_token": admin_token})
    if verbose:
        handler.log_message = BaseHTTPRequestHandler.log_message
    return handler


def make_server(service: EnhanceService, host: str = "127.0.0.1", port: int = 0,
                verbose: bool = False, admin_token: str | None = None) -> ServingHTTPServer:
    """A threading HTTP server bound to ``service`` (port 0 = auto-assign;
    the port is ``server.server_address[1]``). Call ``serve_forever()``.
    ``admin_token`` gates POST /reload (``?token=...``): set it whenever the
    bind address is not loopback, since /reload loads filesystem paths."""
    return ServingHTTPServer((host, port), bound_handler(service, verbose, admin_token))

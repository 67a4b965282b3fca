"""Shared serving types: config, error classes and the queue work item
(port of ``dvae_tpu.serving.types``). Dependency-free, so every serving
module can import them without cycles."""

from __future__ import annotations

import dataclasses
import threading

_Y_SOURCES = ("self-soft", "ones", "zeros", "net")


class ServiceOverloaded(RuntimeError):
    """Raised by ``submit`` when the admission queue is full or the service
    is draining; the HTTP layer maps it to 503 + Retry-After. Bounding the
    queue keeps worst-case latency proportional to ``max_queue/batch_size``
    device batches."""


class EnhancementError(RuntimeError):
    """A worker-side failure (a device batch raised), distinct from the
    ValueErrors ``submit`` raises for invalid client input: the HTTP layer
    reports it as a 500, never as a 400."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 8            # fixed device batch (pad with silence)
    batch_window_ms: float = 25.0  # max wait to fill a micro-batch
    y_source: str = "self-soft"    # default labels for conditional models;
    #                                "net": the service's label network over
    #                                each request's lip video
    y_dim: int = 1
    seed: int = 0
    max_audio_seconds: float = 600.0   # reject oversized requests up front
    warmup_buckets: tuple = (64, 256)  # frame buckets run once before ready
    max_queue: int = 64            # admission cap; beyond it submit raises
    #                                ServiceOverloaded (HTTP 503)
    latency_window: int = 512      # last-N request latencies kept for /stats
    chunk_seconds: float = 0.0     # >0: requests longer than this split into
    #                                hop-aligned chunk items that ride the
    #                                same micro-batch queue and cross-fade on
    #                                the caller's thread (enhance/longform.py)
    pipeline_dispatch: bool = True  # 2-deep worker pipeline: dispatch batch
    #                                k+1 before collecting k; False = strictly
    #                                sequential worker


class _Item:
    __slots__ = ("wav", "y_source", "video", "done", "result", "error", "count",
                 "abandoned", "admitted")

    def __init__(self, wav, y_source, count=True, video=None):
        self.wav = wav
        self.y_source = y_source
        self.video = video        # the request's lip clip, for y_source "net"
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.count = count        # False for warmup traffic (stats-exempt)
        self.abandoned = False    # set by a timed-out waiter; worker drops it
        self.admitted = 0         # tracing.clock() at admission: its queue span

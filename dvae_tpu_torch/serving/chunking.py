"""Chunked and streaming request handling for :class:`EnhanceService`
(port of ``dvae_tpu.serving.chunking``), a mixin so the queue/worker core
(service.py) and the long-request decomposition read apart. Everything here
rides the service's admission queue and locks; its only state is the
``_chunked_inflight`` counter the service initializes.

A long request is decomposed into hop-aligned, equal-length chunk spans
(``enhance.longform.chunk_spans``: every chunk has the same frame bucket,
hence the same device shapes), the chunks ride the same micro-batch queue
as short requests, and the results cross-fade back together on the
caller's thread, with samples yielded as they finalize. Only numpy runs
here: the device work stays on the service's worker thread."""

from __future__ import annotations

import threading
import time

import numpy as np

from dvae_tpu_torch.enhance.longform import StreamingOverlapAdd, chunk_spans
from dvae_tpu_torch.serving.types import ServiceOverloaded
from dvae_tpu_torch.serving.wire import _collect_feed, _feed_into


class _ChunkedStreamingMixin:
    """The chunked-request half of EnhanceService (it relies on the
    service's ``_admit``/``_await``/``_lock``/``cfg``/``enh_cfg``/
    ``max_queue``/``stats``/``_chunked_inflight``)."""

    def _admit_chunk_with_retry(self, chunk, y_source: str, deadline: float):
        """Admission of one chunk of a started long request: a transient
        full queue retries until the request's own deadline instead of
        aborting work already done; drain is bypassed (covered by
        ``_chunked_inflight``)."""
        while True:
            try:
                # count=True: chunk items are device work (utterances,
                # batches, busy_seconds); submit() counts the request once
                return self._admit(chunk, y_source, True, bypass_drain=True,
                                   count_reject=False)
            except ServiceOverloaded:
                if time.monotonic() >= deadline:
                    with self._lock:
                        self.stats["rejected"] += 1
                    raise
                time.sleep(0.02)

    def _stream_chunked(self, wav, y_source: str, timeout: float):
        """(generator) Long request -> chunk items on the shared queue ->
        cross-faded (s_seg, n_seg) pairs as samples finalize: the core
        below with an already complete buffer and no feeder thread. On any
        failure or generator close the remaining chunks are marked
        abandoned; a request that started before drain() may finish."""
        feed = {"received": len(wav), "error": None}
        yield from self._stream_chunked_core(wav, len(wav), y_source, timeout, feed,
                                             threading.Condition())

    def submit_stream_from(self, blocks, n_samples: int, y_source: str | None = None,
                           timeout: float = 900.0):
        """Full-duplex enhancement: :meth:`submit_stream` semantics, but the
        input arrives incrementally too. ``blocks`` is an iterator of
        float32 mono sample blocks (model rate) totalling ``n_samples``.

        With chunking on, each chunk is admitted the moment its samples have
        arrived (a feeder thread drains ``blocks``), so device work on early
        chunks overlaps the upload of the tail. Validation raises here,
        before ``blocks`` is touched; a feed that ends early raises
        ValueError from the generator. Without chunking (or for a feed no
        longer than one chunk) the generator buffers the feed and yields
        once. ``timeout`` is one deadline over upload and device work."""
        y_source = self._check_scalars(int(n_samples), y_source)
        chunk_samples = int(self.cfg.chunk_seconds * self.enh_cfg.stft.fs)

        def run():
            t0 = time.monotonic()
            if 0 < chunk_samples < n_samples:
                yield from self._stream_chunked_from(blocks, n_samples, y_source, timeout)
            else:
                buf = _collect_feed(blocks, n_samples)
                yield self._await(self._admit(buf, y_source, True), timeout)
            self._count_request(n_samples, t0)
        return run()

    def _stream_chunked_from(self, blocks, n_samples: int, y_source: str, timeout: float):
        """(generator) Duplex chunking: a feeder thread fills one float32
        buffer left to right from ``blocks`` (publishing its frontier under
        ``cond``) while :meth:`_stream_chunked_core` admits each chunk once
        its span is fully buffered. Admission (drain check and inflight
        count) happens here, before the feeder starts: a request refused
        during drain must not leave a feeder consuming the socket."""
        self._enter_chunked()
        try:
            buf = np.zeros(n_samples, np.float32)
            cond = threading.Condition()
            feed = {"received": 0, "error": None}

            def feeder():
                def publish(got):
                    with cond:
                        feed["received"] = got
                        cond.notify_all()
                try:
                    _feed_into(blocks, buf, n_samples, publish)
                except BaseException as e:  # surfaced to the consumer, which raises it
                    with cond:
                        if feed["error"] is None:
                            feed["error"] = e
                        cond.notify_all()

            threading.Thread(target=feeder, daemon=True, name="stream-feeder").start()
        except BaseException:
            # the count passes to the core's finally only once the core
            # runs; a failure before that releases it here
            with self._lock:
                self._chunked_inflight -= 1
            raise
        yield from self._stream_chunked_core(buf, n_samples, y_source, timeout, feed, cond,
                                             preadmitted=True)

    def _enter_chunked(self) -> None:
        """Chunked-request admission: refuse while draining, else count the
        request into ``_chunked_inflight`` (drain() waits on it). Paired
        with the decrement in :meth:`_stream_chunked_core`'s finally."""
        with self._lock:
            if self._draining:
                raise ServiceOverloaded(
                    "server is draining for shutdown; retry against another replica")
            self._chunked_inflight += 1

    def _stream_chunked_core(self, buf, n_samples: int, y_source: str, timeout: float,
                             feed: dict, cond: threading.Condition,
                             preadmitted: bool = False):
        """(generator) The one chunked-request implementation: admits each
        chunk of ``buf`` as soon as its span is below ``feed``'s published
        frontier and the sliding window has room, then awaits, cross-fades
        and yields (s_seg, n_seg) pairs as samples finalize."""
        if not preadmitted:
            self._enter_chunked()
        items, n_done = [], 0
        try:
            # everything after admission sits inside the try, so the
            # finally's decrement is unconditional
            stft = self.enh_cfg.stft
            spans = chunk_spans(n_samples, stft.fs, stft.hop, self.cfg.chunk_seconds,
                                min(1.0, self.cfg.chunk_seconds / 4))
            acc_s = StreamingOverlapAdd(spans, n_samples)
            acc_n = StreamingOverlapAdd(spans, n_samples)
            deadline = time.monotonic() + timeout
            # sliding-window admission: at most `window` chunks outstanding,
            # so a request with more chunks than max_queue still serves and
            # one long request cannot hog the queue against short ones
            window = max(1, min(self.max_queue // 2, 4 * self.cfg.batch_size))

            def admissible(received):
                return (len(items) < len(spans) and len(items) - n_done < window
                        and received >= spans[len(items)][1])

            while n_done < len(spans):
                with cond:
                    while True:
                        if feed["error"] is not None:
                            raise feed["error"]
                        received = feed["received"]
                        # progress = admit a data-complete chunk, or await
                        # an admitted one; otherwise wait for bytes
                        if admissible(received) or n_done < len(items):
                            break
                        if not cond.wait(max(0.0, deadline - time.monotonic())):
                            raise TimeoutError("request body stalled (upload slower "
                                               "than the request timeout)")
                while admissible(received):
                    a, b = spans[len(items)]
                    items.append(self._admit_chunk_with_retry(buf[a:b], y_source, deadline))
                if n_done < len(items):
                    s_p, n_p = self._await(items[n_done],
                                           max(0.0, deadline - time.monotonic()))
                    n_done += 1
                    seg = (acc_s.add(s_p), acc_n.add(n_p))
                    if len(seg[0]):
                        yield seg
        except BaseException:
            # includes GeneratorExit: a closed consumer abandons its tail
            for it in items:
                if not it.done.is_set():
                    it.abandoned = True
            raise
        finally:
            with self._lock:
                self._chunked_inflight -= 1

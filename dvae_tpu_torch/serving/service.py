"""The serving core (port of ``dvae_tpu.serving.service``):
:class:`EnhanceService`, the admission queue, the micro-batching worker, hot
reload, warmup and drain. Long-request chunking lives in chunking.py (mixed
in), the HTTP layer in http.py, wire formats in wire.py and the Prometheus
text in metrics.py.

One worker thread does every piece of device work: self-soft labeling,
padding, dispatch, collect and reload. Request threads touch only numpy.
On the card, each batch is the ``Enhancer``'s main path: ``niter`` E-step
chain launches and one Wiener launch of the MH-chain kernel, and one STFT
power launch when the batch holds self-soft items.
"""

from __future__ import annotations

import copy
import queue
import threading
import time

import numpy as np

from dvae_tpu_torch import tracing
from dvae_tpu_torch.enhance.labeling import classify_method_of, constant_labels, self_soft_labels
from dvae_tpu_torch.enhance.mcem import fold_seed
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.ops.stft import n_stft_frames_clamped, samples_for_frames
from dvae_tpu_torch.serving.chunking import _ChunkedStreamingMixin
from dvae_tpu_torch.serving.types import (
    _Y_SOURCES,
    EnhancementError,
    ServeConfig,
    ServiceOverloaded,
    _Item,
)
from dvae_tpu_torch.train.checkpoint import load_checkpoint


class EnhanceService(_ChunkedStreamingMixin):
    """Owns the Enhancer, the request queue and the micro-batching worker.

    ``model_class`` is the ``enhance_wav`` family name (m1/m2/m2v2/v3/v4/v5);
    it decides label handling. ``device`` and ``mesh`` are the Enhancer's:
    CUDA unless ``"cpu"`` is passed (raises without a card), each device
    batch sharded over ``mesh`` when given. Thread-safe: ``submit``
    may be called from any number of threads.
    """

    def __init__(self, model, model_class: str, enh_cfg: EnhancerConfig = EnhancerConfig(),
                 cfg: ServeConfig = ServeConfig(), device=None, mesh=None):
        if cfg.y_source not in _Y_SOURCES:
            raise ValueError(f"bad y_source {cfg.y_source!r}")
        self.model_class = model_class
        self.cfg = cfg
        self.enh_cfg = enh_cfg
        self.conditional = model_class != "m1"
        self.classify_method = classify_method_of(model_class)
        if (self.conditional and self.classify_method is None
                and cfg.y_source == "self-soft"):
            raise ValueError(f"{model_class} has no classifier; serve with "
                             "y_source ones/zeros")
        # the host template checkpoints load into (the Enhancer moves
        # ``model`` itself to the device)
        self._template = copy.deepcopy(model).cpu()
        self.enhancer = Enhancer(model, enh_cfg, device=device, mesh=mesh)
        self.max_queue = max(1, cfg.max_queue)  # the actual admission bound
        self._q: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._lock = threading.Lock()
        self._latencies: list[float] = []  # ring buffer, latency_window deep
        self.stats = {"requests": 0, "failed": 0, "rejected": 0, "batches": 0,
                      "utterances": 0, "audio_seconds": 0.0,
                      "busy_seconds": 0.0, "warmup_seconds": 0.0,
                      "reloads": 0, "timeouts": 0}
        self._latency_window = max(1, cfg.latency_window)
        self.checkpoint = None           # last hot-reloaded checkpoint path
        self._pending_reload = None      # the swap dict the worker applies
        self._draining = False           # drain(): stop admitting work
        self._unfinished = 0             # admitted items not yet answered
        self._warmup_inflight = 0        # the count=False subset (stats-exempt,
        #                                  so the pending gauge excludes it)
        self._chunked_inflight = 0       # chunked requests mid-admission
        self.started = time.time()
        self.ready = threading.Event()   # cleared only by warmup_async
        self.ready.set()
        self.warmup_error: Exception | None = None
        self.warm_buckets: list[int] = []
        self._batch_counter = 0
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True, name="enhance-worker")
        self._worker.start()

    @property
    def device(self):
        return self.enhancer.device

    # -- labels ---------------------------------------------------------------
    def _labels_for_batch(self, batch: list[_Item]) -> list[np.ndarray]:
        """Per-item (n_frames, y_dim) labels: constants per item; every
        self-soft item answered by one batched classifier call (one STFT
        power launch on the card)."""
        ys: list = [None] * len(batch)
        soft = [i for i, it in enumerate(batch) if it.y_source == "self-soft"]
        for i, it in enumerate(batch):
            if it.y_source in ("ones", "zeros"):
                n = n_stft_frames_clamped(len(it.wav), self.enh_cfg.stft)
                ys[i] = constant_labels(n, self.cfg.y_dim, it.y_source)
        if soft:
            labels = self_soft_labels(
                self.enhancer.model, [batch[i].wav for i in soft], self.enh_cfg.stft,
                self.cfg.y_dim, self.classify_method, norm=self.enh_cfg.norm,
                norm_eps=self.enh_cfg.norm_eps)
            for i, lab in zip(soft, labels):
                ys[i] = lab
        return ys

    # -- request path ---------------------------------------------------------
    def _admit(self, wav: np.ndarray, y_source: str, count: bool,
               bypass_drain: bool = False, count_reject: bool = True) -> _Item:
        """Queue one work item. Admission is atomic with drain(): the
        draining check and the unfinished-work increment happen under the
        lock drain() reads, so a request is either refused or answered
        before drain() reports the service empty. ``bypass_drain`` is for
        the remaining chunks of an already started chunked request."""
        item = _Item(wav, y_source, count)
        item.admitted = tracing.clock()
        with self._lock:
            if self._draining and not bypass_drain:
                raise ServiceOverloaded(
                    "server is draining for shutdown; retry against another replica")
            self._unfinished += 1
            if not count:
                self._warmup_inflight += 1
        try:
            self._q.put_nowait(item)
        except queue.Full:
            with self._lock:
                self._unfinished -= 1
                if not count:
                    self._warmup_inflight -= 1
                if count_reject:
                    self.stats["rejected"] += 1
            raise ServiceOverloaded(f"admission queue full ({self.max_queue} pending); "
                                    "retry with backoff") from None
        return item

    def _await(self, item: _Item, timeout: float) -> tuple[np.ndarray, np.ndarray]:
        if not item.done.wait(timeout):
            # abandoned: the worker drops it instead of spending a device
            # batch on a waiter that already gave up; counted in /stats
            item.abandoned = True
            with self._lock:
                self.stats["timeouts"] += 1
            raise TimeoutError("enhancement timed out (server overloaded or device stalled)")
        if item.error is not None:
            raise item.error
        return item.result

    def _count_request(self, n_samples: int, t0: float) -> None:
        with self._lock:
            self.stats["requests"] += 1
            self.stats["audio_seconds"] += n_samples / self.enh_cfg.stft.fs
            self._latencies.append(time.monotonic() - t0)
            if len(self._latencies) > self._latency_window:
                del self._latencies[:-self._latency_window]

    def _check_scalars(self, n_samples: int, y_source: str | None) -> str:
        """Admission validation shared by submit/submit_stream[_from]:
        raises ValueError (HTTP 400) before any work is queued."""
        y_source = y_source or self.cfg.y_source
        if y_source not in _Y_SOURCES:
            raise ValueError(f"bad y_source {y_source!r}")
        if self.conditional and y_source == "self-soft" and self.classify_method is None:
            raise ValueError(f"{self.model_class} has no classifier; use y_source ones/zeros")
        limit = self.cfg.max_audio_seconds * self.enh_cfg.stft.fs
        if n_samples > limit:
            raise ValueError(f"request audio {n_samples / self.enh_cfg.stft.fs:.1f}s"
                             f" exceeds the {self.cfg.max_audio_seconds:.0f}s cap")
        if n_samples == 0:
            raise ValueError("empty audio")
        return y_source

    def _check_request(self, wav, y_source: str | None) -> tuple[np.ndarray, str]:
        y_source = self._check_scalars(len(wav), y_source)
        return np.asarray(wav, np.float32), y_source

    def submit(self, wav: np.ndarray, y_source: str | None = None, timeout: float = 900.0,
               _count_stats: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """Enhance one waveform (float, model rate). Blocks until its
        micro-batch returns; raises on worker-side failure. Returns
        (s_hat, n_hat).

        With ``cfg.chunk_seconds > 0``, longer requests split into chunk
        items riding the same queue and cross-fade back on this thread."""
        wav, y_source = self._check_request(wav, y_source)
        t0 = time.monotonic()
        chunk_samples = int(self.cfg.chunk_seconds * self.enh_cfg.stft.fs)
        # warmup traffic (_count_stats=False) must reach its bucket as one item
        if _count_stats and 0 < chunk_samples < len(wav):
            segs = list(self._stream_chunked(wav, y_source, timeout))
            out = (np.concatenate([s for s, _ in segs]), np.concatenate([n for _, n in segs]))
        else:
            out = self._await(self._admit(wav, y_source, _count_stats), timeout)
        if _count_stats:
            self._count_request(len(wav), t0)
        return out

    def submit_stream(self, wav: np.ndarray, y_source: str | None = None,
                      timeout: float = 900.0):
        """Enhance one waveform incrementally: returns a generator of
        ``(s_seg, n_seg)`` float32 pairs, in order, whose concatenations are
        :meth:`submit`'s ``(s_hat, n_hat)``. A chunked request yields each
        chunk's samples as they finalize; a short one yields once.
        Validation raises here, before anything is admitted; closing the
        generator abandons the chunks not yet served (an abandoned request
        is not counted in the request stats)."""
        wav, y_source = self._check_request(wav, y_source)
        chunk_samples = int(self.cfg.chunk_seconds * self.enh_cfg.stft.fs)

        def run():
            t0 = time.monotonic()
            if 0 < chunk_samples < len(wav):
                yield from self._stream_chunked(wav, y_source, timeout)
            else:
                yield self._await(self._admit(wav, y_source, True), timeout)
            self._count_request(len(wav), t0)
        return run()

    # -- hot reload -----------------------------------------------------------
    def reload_checkpoint(self, path, timeout: float = 60.0) -> None:
        """Swap to a new ``.pt`` checkpoint of the same model without
        downtime. The checkpoint strict-loads into a host copy of the model
        (ValueError when it does not fit); the worker applies it between
        device batches through :meth:`Enhancer.reload`, so every
        single-item request is answered by one weights epoch (a chunked
        request spanning the swap may have its halves answered by the two).
        On any error the running weights are untouched."""
        template = copy.deepcopy(self._template)
        try:
            load_checkpoint(path, template)
        except RuntimeError as e:  # torch's strict-load mismatch
            raise ValueError(f"checkpoint {path} does not fit the served model: {e}") from e
        done = threading.Event()
        swap = {"state": template.state_dict(), "path": str(path), "done": done,
                "error": None}
        with self._lock:
            if self._pending_reload is not None:
                raise RuntimeError("another reload is already in flight")
            self._pending_reload = swap
        if not done.wait(timeout):
            # withdraw the swap so a reported timeout means not applied; if
            # the worker already took it, it is being applied right now
            with self._lock:
                if self._pending_reload is swap:
                    self._pending_reload = None
                    raise TimeoutError("reload not applied in time (device busy?); "
                                       "the previous weights remain live")
            if not done.wait(5.0):
                raise TimeoutError("reload application stalled mid-swap")
        if swap["error"] is not None:
            raise swap["error"]

    def _apply_pending_reload(self):
        with self._lock:
            swap = self._pending_reload
            self._pending_reload = None
        if swap is None:
            return
        try:
            self.enhancer.reload(swap["state"])  # the self-labeling classifier too
            self.checkpoint = swap["path"]
            with self._lock:
                self.stats["reloads"] += 1
        except Exception as e:
            swap["error"] = e
        finally:
            swap["done"].set()

    # -- worker ---------------------------------------------------------------
    def _run(self):
        """The micro-batching worker loop, with 2-deep pipelined dispatch:
        batch k+1 is gathered, labeled and dispatched before batch k's
        results are collected, so the host work of the next batch overlaps
        the device work of the last. With no follow-up traffic the
        in-flight batch is collected at once. ``cfg.pipeline_dispatch=False``
        collects each batch before gathering the next."""
        pending = None  # (live_items, dispatch_handle, t0, batch id) in flight
        while not self._stop.is_set():
            # reloads apply between dispatches: a pending batch already
            # bound the old weights' device work
            self._apply_pending_reload()
            batch = self._gather_batch(block=pending is None)
            nxt = self._dispatch_batch(batch) if batch else None
            if pending is not None:
                self._finish_batch(*pending)
            pending = nxt
            if pending is not None and not self.cfg.pipeline_dispatch:
                self._finish_batch(*pending)
                pending = None
        if pending is not None:  # stop raced an in-flight batch: answer it
            self._finish_batch(*pending)

    def _gather_batch(self, block: bool) -> list[_Item]:
        """Drain up to ``batch_size`` live items (the micro-batch window).
        ``block=False`` (a batch is in flight) polls instead of waiting.
        Records the gather's span and each item's wait in the queue under
        the id of the batch the worker dispatches next."""
        t0 = tracing.clock()
        try:
            first = self._q.get(timeout=0.2) if block else self._q.get_nowait()
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.cfg.batch_window_ms / 1e3
        while len(batch) < self.cfg.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        live = [it for it in batch if not it.abandoned]
        dropped = [it for it in batch if it.abandoned]
        if dropped:
            with self._lock:
                self._unfinished -= len(dropped)
                self._warmup_inflight -= sum(1 for it in dropped if not it.count)
        if live and t0:
            t1 = tracing.clock()
            for it in live:
                tracing.record("service.queue", it.admitted, t1, batch=self._batch_counter)
            tracing.record("service.gather", t0, t1, batch=self._batch_counter)
        return live

    def _dispatch_batch(self, batch: list[_Item]):
        """Label, pad and dispatch one batch; returns the in-flight
        (batch, handle, t0 in ns, batch id), or None if dispatch itself
        failed (the waiters are answered with the error here)."""
        t0 = time.time_ns()
        with tracing.span("service.dispatch", t0) as sp:
            try:
                wavs = [it.wav for it in batch]
                ys = self._labels_for_batch(batch) if self.conditional else None
                # pad to the fixed batch size with 1-frame silence: every batch
                # of a bucket has the same shapes and the same composition
                n_pad = self.cfg.batch_size - len(batch)
                if n_pad > 0:
                    pad_wavs, pad_ys = self._pad_fillers(n_pad)
                    wavs = wavs + pad_wavs
                    if ys is not None:
                        ys = ys + pad_ys
                with self._lock:
                    key_idx = self._batch_counter
                    self._batch_counter += 1
                sp.set(batch=key_idx)
                handle = self.enhancer.dispatch(wavs, ys, seed=fold_seed(self.cfg.seed, key_idx))
                return batch, handle, t0, key_idx
            except Exception as e:
                self._fail_batch(batch, e)
                with self._lock:
                    self._unfinished -= len(batch)
                    self._warmup_inflight -= sum(1 for it in batch if not it.count)
                return None

    def _finish_batch(self, batch: list[_Item], handle, t0: int, key_idx: int) -> None:
        """Collect a dispatched batch's results and answer its waiters.
        ``busy_seconds`` spans dispatch start to results fetched; under
        pipelining consecutive spans overlap by design."""
        with tracing.span("service.finish", batch=key_idx) as sp:
            try:
                out = self.enhancer.collect(handle)
                for it, (s, n) in zip(batch, out):
                    it.result = (s, n)
                    it.done.set()
                # warmup batches (count=False) go to warmup_seconds, never to
                # the serving rtf/throughput counters; a mixed batch's span
                # counts as warmup too
                counted = [it for it in batch if it.count]
                t1 = time.time_ns()
                sp.end_at(t1)
                span = (t1 - t0) / 1e9
                with self._lock:
                    if counted:
                        self.stats["batches"] += 1
                        self.stats["utterances"] += len(counted)
                    if len(counted) == len(batch):
                        self.stats["busy_seconds"] += span
                    else:
                        self.stats["warmup_seconds"] += span
            except Exception as e:
                self._fail_batch(batch, e)
            finally:
                with self._lock:
                    self._unfinished -= len(batch)
                    self._warmup_inflight -= sum(1 for it in batch if not it.count)

    def _fail_batch(self, batch: list[_Item], e: Exception) -> None:
        """Answer every waiter of a failed batch with an EnhancementError
        (HTTP 500) and count it; keep serving."""
        err = EnhancementError(f"enhancement failed: {e}")
        err.__cause__ = e
        for it in batch:
            it.error = err
            it.done.set()
        with self._lock:
            self.stats["failed"] += sum(1 for it in batch if it.count)

    # -- lifecycle --------------------------------------------------------------
    def warmup(self, buckets=None, timeout: float = 1800.0):
        """Run one batch of each frame bucket before serving. On the card
        the first batch builds both kernels with nvcc, creates the CUDA
        context and fills the caching allocator; a build failure fails the
        warmup. Client traffic that fills the queue meanwhile is retried
        until the deadline, never taken for a broken model."""
        buckets = tuple(buckets if buckets is not None else self.cfg.warmup_buckets)
        deadline = time.monotonic() + timeout
        for b in buckets:
            wav = np.zeros(samples_for_frames(int(b), self.enh_cfg.stft), np.float32)
            while True:
                if self._draining:  # shutdown won the race: stand down
                    return
                try:
                    self.submit(wav, "zeros" if (self.conditional
                                                 and self.classify_method is None) else None,
                                timeout=max(1.0, deadline - time.monotonic()),
                                _count_stats=False)
                    break
                except ServiceOverloaded:
                    if self._draining:  # an operator stop mid-warmup: clean exit
                        return
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.2)
            self.warm_buckets.append(int(b))

    def _pad_fillers(self, n: int):
        """The (wav, label) fillers a short batch is padded with: 1-frame
        silences."""
        wavs = [np.zeros(self.enh_cfg.stft.nfft, np.float32)] * n
        ys = [np.zeros((1, self.cfg.y_dim), np.float32)] * n if self.conditional else None
        return wavs, ys

    def warmup_async(self, buckets=None, timeout: float = 1800.0, on_done=None) -> None:
        """Run :meth:`warmup` on a background thread so the HTTP listener
        serves meanwhile: /healthz answers "warming", requests admit and
        queue behind the warmup items, and ``ready`` flips only when every
        bucket has run. A failure lands in ``warmup_error`` (/healthz
        "warmup failed"), ``ready`` stays unset, and ``on_done(error)`` lets
        the caller decide to exit."""
        self.ready.clear()

        def run():
            err = None
            try:
                self.warmup(buckets, timeout)
            except Exception as e:  # surfaced through healthz and on_done
                err = e
                self.warmup_error = e
            else:
                self.ready.set()
            if on_done is not None:
                on_done(err)

        threading.Thread(target=run, daemon=True, name="warmup").start()

    def drain(self, timeout: float = 600.0) -> bool:
        """Graceful shutdown: stop admitting (new submits raise
        ServiceOverloaded -> HTTP 503), wait for every admitted request to
        be answered, then stop the worker. False if in-flight work outlived
        ``timeout`` (the worker is stopped regardless)."""
        self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                # chunked requests that started before the flag flipped keep
                # admitting their remaining chunks: wait for them too
                if self._unfinished == 0 and self._chunked_inflight == 0:
                    break
            time.sleep(0.05)
        with self._lock:
            drained = self._unfinished == 0 and self._chunked_inflight == 0
        self.close()
        return drained

    def stats_snapshot(self) -> dict:
        """Counters and live gauges as one consistent dict (the /stats body):
        the cumulative ``stats``, ``pending`` (admitted, not yet answered),
        ``rtf`` (busy/audio seconds) and p50/p90/p99 latency over the last
        ``latency_window`` requests."""
        with self._lock:
            stats = dict(self.stats)
            lat = list(self._latencies)
            stats["pending"] = self._unfinished - self._warmup_inflight
        stats["rtf"] = (round(stats["busy_seconds"] / stats["audio_seconds"], 5)
                        if stats["audio_seconds"] else None)
        if lat:
            q = np.quantile(lat, [0.5, 0.9, 0.99])
            stats["latency_seconds"] = {
                "p50": round(float(q[0]), 4), "p90": round(float(q[1]), 4),
                "p99": round(float(q[2]), 4), "mean": round(float(np.mean(lat)), 4),
                "window": len(lat)}
        return stats

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        # answer everything still queued: each waiter is an HTTP handler
        # thread blocked in _await, which server_close() joins
        leftovers = []
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        if leftovers:
            err = EnhancementError("server closed before this request was served")
            for it in leftovers:
                it.error = err
                it.done.set()
            with self._lock:
                self._unfinished -= len(leftovers)
                self._warmup_inflight -= sum(1 for it in leftovers if not it.count)
                self.stats["failed"] += sum(1 for it in leftovers if it.count)

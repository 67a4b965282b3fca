"""Persistent enhancement service over HTTP (port of ``dvae_tpu.serving``).

One process holds the model on the card and answers enhancement requests
over plain HTTP (stdlib ``http.server``):

* **Micro-batching.** Concurrent requests are drained from a queue for up
  to ``batch_window_ms`` and enhanced as one ``Enhancer`` batch, padded to
  a fixed ``batch_size`` with 1-frame silent utterances. On the card every
  batch runs the MH-chain kernel (``niter`` E-step launches and one Wiener
  launch) and, for self-soft items, one STFT power launch.
* **Warmup.** ``EnhanceService.warmup()`` runs one batch of each frame
  bucket before the first request: it builds the kernels, creates the CUDA
  context and fills the caching allocator.
* **Self-labeling.** Conditional models (v3/v4/v5) label requests with
  their own x->y classifier; ``ones``/``zeros`` are the constant ablations.

Wire protocol (see ``http.RequestHandler``):
  POST /enhance?return=speech|noise|stereo&resample=1&y_source=...&stream=1
      body: a RIFF/WAVE file -> 200 with an audio/wav body (model-rate
      PCM16; stereo = channel 0 speech, channel 1 noise, which sum to the
      input). ``stream=1`` delivers the exact-length wav body as chunk
      cross-fades finalize, and reads a model-rate PCM body while enhancing.
  GET /healthz, GET /stats, GET /metrics (Prometheus text)
  POST /reload?checkpoint=<path.pt>[&token=...] -> hot swap to a new
      checkpoint of the same model, applied between device batches.

Modules: ``service`` (queue, worker, reload, warmup, drain), ``chunking``
(long requests), ``http`` (handler, ``make_server``), ``wire`` (RIFF/PCM),
``metrics`` (Prometheus text) and ``boot`` (boot ledger and early bind,
stdlib only).

Re-exports are lazy (PEP 562): ``boot`` must import before torch does.
"""

_EXPORTS = {
    "RequestHandler": "http", "make_server": "http",
    "_PROM_COUNTERS": "metrics", "_prometheus_text": "metrics",
    "EnhanceService": "service",
    "EnhancementError": "types", "ServeConfig": "types", "ServiceOverloaded": "types",
    "_Item": "types", "_Y_SOURCES": "types",
    "_collect_feed": "wire", "_feed_into": "wire",
    "_parse_wav_bytes": "wire", "_pcm_seg_bytes": "wire",
    "_pcm_to_float_mono": "wire", "_riff_header": "wire",
    "_riff_stream_info": "wire", "_wav_bytes": "wire",
    "_STREAMABLE_PCM": "wire",
    "BootTimer": "boot", "bind_boot_server": "boot", "attach_service": "boot",
}

__all__ = [
    "EnhanceService", "ServeConfig", "ServiceOverloaded", "EnhancementError",
    "RequestHandler", "make_server",
    "BootTimer", "bind_boot_server", "attach_service",
]


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

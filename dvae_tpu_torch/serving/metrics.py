"""Prometheus text exposition of the serving stats, the GET /metrics body
(port of ``dvae_tpu.serving.metrics``, with the same metric names). Renders
the same ``stats_snapshot()`` dict as the JSON /stats view."""

from __future__ import annotations

import time

_PROM_COUNTERS = (
    # (stats key, metric name, help): cumulative-since-start counters
    ("requests", "dvae_requests_total", "Answered enhancement requests"),
    ("failed", "dvae_requests_failed_total", "Requests answered with an error"),
    ("rejected", "dvae_requests_rejected_total",
     "Requests refused at admission (queue full or draining)"),
    ("timeouts", "dvae_requests_timeout_total",
     "Requests abandoned by their waiter before the device answered"),
    ("batches", "dvae_device_batches_total", "Device batches dispatched"),
    ("utterances", "dvae_utterances_total",
     "Utterances/chunks enhanced (>= requests under chunking)"),
    ("reloads", "dvae_checkpoint_reloads_total", "Hot checkpoint swaps applied"),
    ("audio_seconds", "dvae_audio_seconds_total", "Audio seconds enhanced"),
    ("busy_seconds", "dvae_device_busy_seconds_total",
     "Wall seconds the worker spent on device batches"),
    ("warmup_seconds", "dvae_warmup_seconds_total",
     "Wall seconds spent on warmup batches"),
)


def _prometheus_text(svc) -> str:
    """The /stats counters in Prometheus text exposition format (0.0.4):
    counters as counters, queue pressure / readiness / RTF as gauges, and
    the rolling-window latency quantiles as quantile-labelled gauges (a
    ring buffer of the last ``latency_window`` requests, not a cumulative
    summary)."""
    st = svc.stats_snapshot()
    out = []
    for key, name, help_ in _PROM_COUNTERS:
        out.append(f"# HELP {name} {help_}.")
        out.append(f"# TYPE {name} counter")
        out.append(f"{name} {st[key]}")
    out.append("# HELP dvae_pending_requests Admitted but not yet answered.")
    out.append("# TYPE dvae_pending_requests gauge")
    out.append(f"dvae_pending_requests {st['pending']}")
    out.append("# HELP dvae_ready 1 once warmup finished (readiness probe).")
    out.append("# TYPE dvae_ready gauge")
    out.append(f"dvae_ready {int(svc.ready.is_set())}")
    if st["rtf"] is not None:
        out.append("# HELP dvae_rtf Device real-time factor "
                   "(busy seconds per audio second).")
        out.append("# TYPE dvae_rtf gauge")
        out.append(f"dvae_rtf {st['rtf']}")
    lat = st.get("latency_seconds")
    if lat:
        name = "dvae_request_latency_seconds"
        out.append(f"# HELP {name} Request latency over the last "
                   f"{lat['window']} requests (rolling window).")
        out.append(f"# TYPE {name} gauge")
        for q, k in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            out.append(f'{name}{{quantile="{q}"}} {lat[k]}')
        # a standalone gauge, not a suffix of the quantile family above:
        # OpenMetrics-strict parsers misread suffixed names on a typed family
        out.append("# HELP dvae_request_latency_window_size Number of "
                   "requests in the rolling latency window.")
        out.append("# TYPE dvae_request_latency_window_size gauge")
        out.append(f"dvae_request_latency_window_size {lat['window']}")
    out.append("# HELP dvae_uptime_seconds Seconds since service start.")
    out.append("# TYPE dvae_uptime_seconds gauge")
    out.append(f"dvae_uptime_seconds {round(time.time() - svc.started, 1)}")
    return "\n".join(out) + "\n"

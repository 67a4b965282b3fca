"""Metric aggregation (the port's copy of ``dvae_tpu.eval.stats``): 95% CI
tables grouped by SNR / noise type / stationarity / speaker (the reference's
packages/metrics.py:84-168), plus the JSON dump the reference left
commented out (metrics.py:109-111). Kept operation for operation, so that
the tables and ``stats.json`` equal the JAX package's."""

from __future__ import annotations

import json

import numpy as np
import scipy.stats


def mean_confidence_interval(data, confidence: float = 0.95):
    a = 1.0 * np.asarray(data)
    n = len(a)
    m = np.mean(a)
    if n < 2:
        # sem(ddof=1) is NaN for one sample; NaN would also make the
        # stats.json invalid JSON downstream
        return np.round(m, 3), 0.0
    se = scipy.stats.sem(a)
    h = se * scipy.stats.t.ppf((1 + confidence) / 2.0, n - 1)
    return np.round(m, 3), np.round(h, 3)


def _table(metrics: dict, mask=None, confidence: float = 0.95, out=print):
    stats = {}
    out("{:<10} {:<10} {:<10}".format("METRIC", "AVERAGE", "CONF. INT."))
    for key, vals in metrics.items():
        vals = np.asarray(vals, dtype=np.float64)
        if mask is not None:
            vals = vals[mask]
        # a metric can be NaN for individual utterances (e.g. classifier-F1
        # columns when that utterance has no stored classifier output) —
        # exclude them rather than poisoning the mean / stats.json
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            stats[key] = {"avg": None, "+/-": None}
            out("{:<10} {:<10} {:<10}".format(key, "n/a", "n/a"))
            continue
        m, h = mean_confidence_interval(vals, confidence)
        stats[key] = {"avg": float(m), "+/-": float(h)}
        out("{:<10} {:<10} {:<10}".format(key, m, h))
    out("")
    return stats


def compute_stats(
    metrics_keys,
    all_metrics,
    model_data_dir=None,
    confidence: float = 0.95,
    all_snr_db=None,
    all_noise_types=None,
    all_speakers=None,
    all_noise_stationarities=None,
    out=print,
):
    """Print overall + grouped CI tables; returns (and optionally saves) the
    stats dict."""
    metrics = {k: [row[i] for row in all_metrics] for i, k in enumerate(metrics_keys)}

    result = {"overall": _table(metrics, None, confidence, out)}

    def grouped(tag, groups):
        if groups is None:
            return
        groups = np.asarray(groups)
        result[tag] = {}
        for val in sorted(set(groups.tolist())):
            out(f"{tag} = {val}")
            result[tag][str(val)] = _table(metrics, groups == val, confidence, out)

    grouped("snr_db", all_snr_db)
    grouped("noise_type", all_noise_types)
    grouped("stationarity", all_noise_stationarities)
    grouped("speaker", all_speakers)

    if model_data_dir is not None:
        with open(str(model_data_dir).rstrip("/") + "/stats.json", "w") as f:
            json.dump(result, f, indent=1)
    return result

"""One run of one cell: set-up, the measured window, the per-layer readers
and the comparison that decides ``correct``.

``run`` takes the device as an argument, so the tests can drive a whole
run on the CPU at a small size; ``run.py`` asks for the card.
"""

from __future__ import annotations

import dataclasses
import importlib
import subprocess
import sys
import types

import numpy as np

from benchmark import check, drive, probe, spec, trace, weights, work
from benchmark.reference.dsp import Stft

#: top-level modules the measured process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "dvae_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 and done.stdout else None


#: keys of a network's entry in a configuration that are not the class's
#: keyword arguments
NET_KEYS = ("class", "program", "stats")


def _network(entry: dict, w: dict, device):
    """The ``dvae_tpu_torch.models`` class ``entry["class"]`` built from the
    entry's keyword arguments, holding the weights ``w``."""
    from dvae_tpu_torch import models

    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in entry.items() if k not in NET_KEYS}
    model = getattr(models, entry["class"])(**kw).to(device)
    model.load_state_dict(w, strict=True)
    return model.eval()


def resolve(name: str):
    """The object ``"module:attribute"`` names."""
    module, _, attr = name.partition(":")
    return getattr(importlib.import_module(module), attr)


def _enhancer_config(cfg: dict):
    from dvae_tpu_torch.enhance.mcem import McemConfig
    from dvae_tpu_torch.enhance.pipeline import EnhancerConfig
    from dvae_tpu_torch.ops.stft import StftConfig

    return EnhancerConfig(stft=StftConfig(**cfg["stft"]), mcem=McemConfig(**cfg["mcem"]),
                          **cfg["enhancer"])


def _finite(answer) -> bool:
    return answer is not None and all(np.isfinite(np.asarray(a)).all() for a in answer)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        sync=lambda: None, memory_peak=lambda: 0) -> dict:
    """Run ``cell`` once. Returns ``{"result": <the result line without
    its device>, "checks": {name: {value, limit}}, "notes": {...}}``."""
    seed = int(seed) % 2**63
    cfg, traffic = cell.config, cell.traffic
    ref = cell.reference
    rng = np.random.default_rng([seed, 2])
    lo, hi = cell.check["dispatch"]
    target = int(rng.integers(lo, hi))
    iterations = sorted(rng.choice(cfg["mcem"]["niter"], size=min(cell.check.get(
        "iterations", 3), cfg["mcem"]["niter"]), replace=False).tolist())
    probe_ = probe.Probe(target, iterations, traced)

    w = weights.make(ref.params(cfg), seed, device)
    model = _network(cfg["model"], w, device)
    label_w = label_net = None
    if cfg.get("label_net"):  # a network of its own, its weights from a stream of their own
        label_w = weights.make(ref.label_params(cfg), seed, device, stream=1)
        label_net = _network(cfg["label_net"], label_w, device)
    enh_cfg = _enhancer_config(cfg)
    wavs, side = drive.pool(traffic, seed, device, Stft(**cfg["stft"]), cfg.get("inputs", ()))
    tracer = trace.DeviceTrace() if traced else None
    if traffic["mode"] == "batches":
        window = _batches(cell, model, label_net, enh_cfg, wavs, side, probe_, tracer, seed,
                          seconds, device, sync)
    elif traffic["mode"] == "open_loop":
        window = _open_loop(cell, model, label_net, enh_cfg, wavs, side, probe_, tracer, seed,
                            seconds, device, sync)
    else:
        raise ValueError(f"bad traffic mode {traffic['mode']!r}")
    peak = memory_peak()
    probe_.remove()
    setup_s = window["t0"] - t_start
    notes = {k: window[k] for k in ("late_max_s", "refused") if k in window}
    if traced:
        metrics = _per_layer(cell, ref, window, probe_, tracer)
        notes["traced_end_to_end"] = window["e2e"]
    else:
        metrics = {**window["e2e"], "setup_s": setup_s}
    notes["forbidden_after_window"] = forbidden_modules()
    # -- correct: the answers, then the recorded dispatch against the reference,
    # once the program's objects are freed
    del model, label_net, window["drop"]
    sync()
    extra = {} if label_w is None else {"label_weights": label_w, "side": window["side"]}
    nums = check.numbers(probe_.record, window["outputs"], w, cfg, ref, **extra)
    nums["answers_bad"] = float(window["bad"])
    ok, table = check.verdict(nums, cell.limits)
    result = {"correct": bool(ok), "attempted": window["attempted"], "failed": window["failed"],
              "metrics": {k: {"value": v, "unit": _unit(cell, k)} for k, v in metrics.items()}}
    if traced:
        result["breakdown"] = trace.breakdown(tracer.events, tracer.window, probe_.spans)
        busy = trace.busy_ns(tracer.events, tracer.window) / 1e9
        notes["busy_s"], notes["window_s"] = busy, (tracer.window[1] - tracer.window[0]) / 1e9
    notes["memory_peak_bytes"] = peak
    return {"result": result, "checks": table, "notes": notes}


def _unit(cell, name):
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)


def _labeler(cfg, enh, label_net):
    """(wavs, side inputs) -> per-utterance labels: the prior's own
    self-soft labels, or the configuration's label network through the
    program's ``label_net.program``; None without labels."""
    from dvae_tpu_torch.enhance.labeling import self_soft_labels

    lab = cfg.get("labels")
    if not lab:
        return None
    if lab["source"] == "net":
        program, stats = resolve(cfg["label_net"]["program"]), cfg["label_net"].get("stats")
        return lambda ws, side: program(label_net, ws, side, enh.cfg.stft, stats)
    return lambda ws, side: self_soft_labels(enh.model, ws, enh.cfg.stft, lab["y_dim"],
                                             lab["method"])


def _paired(rec_wavs, side, index) -> dict:
    """``{input: [the side input paired with each recorded mixture]}``,
    found by each mixture's array object through ``index`` (id -> pool
    position); None for a mixture no caller sent."""
    return {k: [v[index[id(x)]] if id(x) in index else None for x in rec_wavs]
            for k, v in side.items()}


def _batches(cell, model, label_net, enh_cfg, wavs, side, probe_, tracer, seed, seconds, device,
             sync):
    from dvae_tpu_torch.enhance.pipeline import Enhancer

    cfg = cell.config
    enh = Enhancer(model, enh_cfg, device=device)
    drv = drive.Batches(enh, cell.traffic, wavs, _labeler(cfg, enh, label_net), side)
    warm_cfg = dataclasses.replace(enh_cfg, mcem=dataclasses.replace(enh_cfg.mcem, niter=2))
    drv.warm(Enhancer(model, warm_cfg, device=device))
    sync()
    probe_.install(enh)
    probe_.window_open = True
    if tracer:
        tracer.start()
    res = drv.run(seconds, seed, probe_, min_batches=probe_.target + 1)
    if tracer:
        tracer.stop()
    sync()
    probe_.window_open = False
    fs = cfg["stft"]["fs"]
    fed = res["fed"]
    n_utt = sum(len(b) for b, _ in fed)
    bad = sum(1 for _, out in fed for a in out if not _finite(a))
    audio = sum(len(x) for b, _ in fed for x in b) / fs
    window_s = res["t1"] - res["t0"]
    answers = res["answers"]
    pool_index = {id(x): i for i, x in enumerate(wavs)}
    return {"t0": res["t0"], "t1": res["t1"], "attempted": n_utt, "failed": bad, "bad": bad,
            "e2e": {"offline_audio_s_per_s": audio / window_s},
            "outputs": answers if answers is not None else [],
            "side": _paired(probe_.record.get("wavs") or [], side, pool_index),
            "utterance_lengths": [len(x) for b, _ in fed for x in b], "window_s": window_s,
            "drop": [enh, drv, res]}


def _open_loop(cell, model, label_net, enh_cfg, wavs, side, probe_, tracer, seed, seconds,
               device, sync):
    from dvae_tpu_torch.serving.service import EnhanceService
    from dvae_tpu_torch.serving.types import ServeConfig

    cfg, traffic = cell.config, cell.traffic
    lab = cfg.get("labels") or {}
    scfg = ServeConfig(y_dim=lab.get("y_dim", 1),
                       seed=seed % 2**31, **({"y_source": lab["source"]} if lab else {}))
    # a label network of its own goes to the service, which labels each batch with it
    nets = {} if label_net is None else {"label_net": label_net,
                                         "label_stats": cfg["label_net"].get("stats")}
    svc = EnhanceService(model, cfg["family"], enh_cfg, scfg, device=device, **nets)
    due = drive.due_times(traffic, seconds, seed)
    # one array object per request, so the recorded batch maps to its callers
    requests = [wavs[i % len(wavs)][:] for i in range(len(due))]
    sent = [{k: v[i % len(wavs)] for k, v in side.items()} for i in range(len(due))]
    st = Stft(**cfg["stft"])
    bucket = enh_cfg.frame_bucket
    buckets = sorted({-(-st.frames(len(x)) // bucket) * bucket for x in wavs})
    try:
        svc.warmup(buckets=buckets)
        sync()
        probe_.install(svc.enhancer, svc)
        before = svc.stats_snapshot()
        probe_.window_open = True
        if tracer:
            tracer.start()
        res = drive.OpenLoop(svc, traffic, requests, due, sent).run(seconds)
        if tracer:
            tracer.stop()
        sync()
        probe_.window_open = False
        after = svc.stats_snapshot()
    finally:
        svc.close()
    lat = np.asarray(res["latency"])
    ok = np.isfinite(lat)
    p95 = float(np.percentile(lat, 95))
    if not np.isfinite(p95):  # over 5% unanswered: the whole run's wall stands in
        p95 = float(res["t1"] - res["t0"])
    by_id = {id(r): i for i, r in enumerate(requests)}
    rec_wavs = probe_.record.get("wavs") or []
    outputs = [res["answers"][by_id[id(x)]] if id(x) in by_id else None for x in rec_wavs]
    pool_index = {k: i % len(wavs) for k, i in by_id.items()}
    answered = [a for a in res["answers"] if a is not None]
    stats = {k: after[k] - before[k] for k in ("requests", "batches", "utterances", "rejected",
                                               "failed")}
    return {"t0": res["t0"], "t1": res["t1"], "attempted": len(due),
            "failed": int((~ok).sum()), "bad": sum(1 for a in answered if not _finite(a))
            + res["alive"], "e2e": {"serve_p95_s": p95}, "outputs": outputs,
            "side": _paired(rec_wavs, side, pool_index),
            "utterance_lengths": [len(requests[i]) for i in range(len(due)) if ok[i]],
            "window_s": res["t1"] - res["t0"], "service": stats,
            "batch_size": scfg.batch_size, "late_max_s": res["late_max_s"],
            "refused": stats["rejected"], "drop": [svc, res]}


def _per_layer(cell, ref, window, probe_, tracer) -> dict:
    """Each per-layer metric the cell reports, from its reader; a reader
    that finds nothing returns None and the metric is left out."""
    cfg = cell.config
    mc = cfg["mcem"]
    m = cfg["model"]
    st = Stft(**cfg["stft"])
    lab = cfg.get("labels") or {}
    clf = m["h_dim"] if lab.get("source") == "self-soft" else None
    flops = sum(work.enhance_flops(st.frames(n), mc, m["x_dim"], m["z_dim"],
                                   tuple(reversed(m["h_dim"])), st.nfft, lab.get("y_dim", 0), clf)
                for n in window["utterance_lengths"])
    label_flops = getattr(ref, "label_flops", None)
    if label_flops is not None:  # the label network's work, whatever implements it
        flops += sum(label_flops(cfg, st.frames(n)) for n in window["utterance_lengths"])
    run = types.SimpleNamespace(
        cell=cell, config=cfg, spans=dict(probe_.spans), chain_calls=probe_.chain_calls,
        mstep_events=probe_.mstep_events, power_calls=probe_.power_calls,
        events=tracer.events, trace_window=tracer.window, window_s=window["window_s"],
        flops=flops, service=window.get("service"), batch_size=window.get("batch_size"))
    out = {}
    for metric in cell.per_layer:
        value = spec.metric_reader(metric["name"])(run)
        if value is not None:
            out[metric["name"]] = float(value)
    return out

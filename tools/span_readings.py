#!/usr/bin/env python3
"""Run one benchmark cell traced, with the port's span recorder
(``dvae_tpu_torch.tracing``) on over the profiler's window, and print what
the program's spans read.

    python3 tools/span_readings.py --workload <cell> --seed <n> --seconds <s> [--spans 0|1]
    python3 tools/span_readings.py --span-cost

One run per process, as ``benchmark/run.py``: this calls its ``main`` with
``--trace 1``, so its result line is printed as usual, after wrapping
``DeviceTrace.start`` and ``stop`` to switch the recorder on once the
profiler has started and off after the window's final synchronize
(``--spans 0`` leaves it off: the same traced run without the recorder).
The last line of standard output is one JSON object: the cell, the seed,
the result line's ``correct`` and end-to-end numbers, the span readings of
:func:`readings` over the spans that lie in the window (the video
labeller's, :func:`video_readings`, where a label network runs), the ten longest
idle gaps named by the innermost span open at their start (the probe's
and the program's, ``service.queue`` left out: a wait, not host work), and
how many of them start while a program span is open and are named by one.

``--span-cost`` prints the host time of one span call with the recorder
off and on, and of the bare loop, in ns (``timeit``, best of 5).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import pathlib
import sys
import timeit

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the dispatch's children that should partition it
PARTS = ("enhancer.prepare", "enhancer.upload", "enhancer.enqueue")
#: the attributes of the video labeller's span
VIDEO_ATTRS = ("utterances", "frames", "padded_frames", "clip_bytes")


def _ms(ns) -> float:
    return float(ns) / 1e6


class _Index:
    """The spans of each name, per thread, sorted by start."""

    def __init__(self, spans):
        self.by = collections.defaultdict(list)
        for s in sorted(spans, key=lambda s: s.start_ns):
            self.by[(s.name, s.thread)].append(s)
        self.starts = {k: [s.start_ns for s in v] for k, v in self.by.items()}

    def named(self, name):
        return sorted((s for (n, _), v in self.by.items() if n == name for s in v),
                      key=lambda s: s.start_ns)

    def inside(self, outer, name):
        """The spans ``name`` on ``outer``'s thread that lie within it."""
        key = (name, outer.thread)
        if key not in self.by:
            return []
        v, st = self.by[key], self.starts[key]
        i = bisect.bisect_left(st, outer.start_ns)
        j = bisect.bisect_right(st, outer.end_ns)
        return [s for s in v[i:j] if s.end_ns <= outer.end_ns]


def readings(spans) -> dict:
    """What the spans read: medians per dispatch (so the dispatch the
    benchmark's probe records, and clones, does not set them), the queue's
    95th percentile, and each span's median and count."""
    ix = _Index(spans)
    out = {}
    dispatches = ix.named("enhancer.dispatch")
    enqueue, upload, ratio = [], {}, []
    for d in dispatches:
        parts = {p: sum(s.end_ns - s.start_ns for s in ix.inside(d, p)) for p in PARTS}
        enqueue.append(parts["enhancer.enqueue"])
        upload[d.attrs["batch"]] = parts["enhancer.upload"]
        if d.end_ns > d.start_ns:
            ratio.append(sum(parts.values()) / (d.end_ns - d.start_ns))
    wait = {}
    for c in ix.named("enhancer.collect"):
        wait[c.attrs["batch"]] = sum(s.end_ns - s.start_ns
                                     for s in ix.inside(c, "enhancer.collect.wait"))
    both = sorted(set(upload) & set(wait))
    queue = [s.end_ns - s.start_ns for s in ix.named("service.queue")]
    if enqueue:
        out["host.enqueue_ms"] = _ms(np.median(enqueue))
        out["partition_median"] = float(np.median(ratio))
        out["partition_min"] = float(np.min(ratio))
    if both:
        out["host.sync_wait_ms"] = _ms(np.median([upload[b] + wait[b] for b in both]))
        out["upload_ms"] = _ms(np.median([upload[b] for b in both]))
        out["collect_wait_ms"] = _ms(np.median([wait[b] for b in both]))
    if queue:
        out["serve.queue_wait_p95_ms"] = _ms(np.percentile(queue, 95))
        out["queue_wait_p50_ms"] = _ms(np.median(queue))
        out["requests"] = len(queue)
    # one EM iteration's host time (E-step + M-step + cost) in its batch's
    # first and last 10 iterations: a launch queue the device has filled
    # slows only the later ones
    first, last = [], []
    for e in ix.named("enhancer.enqueue"):
        its = collections.defaultdict(int)
        for name in ("mcem.estep", "mcem.mstep", "mcem.cost"):
            for s in ix.inside(e, name):
                its[s.attrs["it"]] += s.end_ns - s.start_ns
        if len(its) >= 20:
            first += [its[i] for i in sorted(its)[:10]]
            last += [its[i] for i in sorted(its)[-10:]]
    if first:
        out["iteration_ms_first10"] = _ms(np.median(first))
        out["iteration_ms_last10"] = _ms(np.median(last))
    for name, key in (("labels", "labels_ms"), ("mcem.mstep", "mstep.host_ms")):
        got = [s.end_ns - s.start_ns for s in ix.named(name)]
        if got:
            out[key] = _ms(np.median(got))
    video = ix.named("labels.video")
    if video:
        out["labels.video"] = video_readings(ix, video)
    names = sorted({n for n, _ in ix.by})
    out["median_ms"] = {n: _ms(np.median([s.end_ns - s.start_ns for s in ix.named(n)]))
                        for n in names}
    out["count"] = {n: len(ix.named(n)) for n in names}
    return out


def video_readings(ix, video) -> dict:
    """The video labeller's calls (``labels.video``): medians per call of
    its time, of its upload (gather and copy) and of its network (forward
    and copy back) inside it, and of its attributes; and the share of the
    frames the network ran that were padding."""
    def inner(name):
        return [sum(s.end_ns - s.start_ns for s in ix.inside(v, name)) for v in video]

    out = {"calls": len(video),
           "ms": _ms(np.median([v.end_ns - v.start_ns for v in video])),
           "upload_ms": _ms(np.median(inner("labels.upload"))),
           "net_ms": _ms(np.median(inner("labels.net")))}
    for attr in VIDEO_ATTRS:
        out[attr] = float(np.median([v.attrs[attr] for v in video]))
    padded = sum(v.attrs["padded_frames"] for v in video)
    out["pad_share"] = 1.0 - sum(v.attrs["frames"] for v in video) / padded if padded else None
    return out


def named_gaps(breakdown, events, window, probe_spans, program, top=10) -> dict:
    """The longest idle gaps named by ``breakdown`` (``trace.breakdown``)
    after the innermost span (probe's or program's) open at their start,
    and how many that start inside a program span are named by one."""
    from benchmark import trace

    merged = {k: list(v) for k, v in probe_spans.items()}
    for s in program:
        if s.name != "service.queue":
            merged.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    gaps = breakdown(events, window, merged, top)["idle_gaps"]
    lo, hi = window
    # the gaps' starts, as breakdown finds them
    starts, last = [], lo
    for s, e in trace.busy_intervals(events) + [[hi, hi]]:
        s, e = max(s, lo), min(e, hi)
        if s > last:
            starts.append((s - last, last))
        last = max(last, e)
    starts.sort(reverse=True)
    names = {s.name for s in program if s.name != "service.queue"}
    open_at = sum(any(s.start_ns <= at < s.end_ns for s in program if s.name in names)
                  for _, at in starts[:top])
    by_program = sum(name.removeprefix("host.") in names for name, _ in gaps)
    return {"idle_gaps": gaps, "gaps_in_program_span": open_at,
            "gaps_named_by_program": by_program}


def span_cost() -> dict:
    from dvae_tpu_torch import tracing

    def best(stmt, n):
        return min(timeit.repeat(stmt, number=n, repeat=5, globals={"tracing": tracing})) / n * 1e9

    bare = best("pass", 1_000_000)
    off = best("with tracing.span('mcem.mstep', it=1):\n    pass", 1_000_000)
    tracing.enable()
    try:
        on = best("with tracing.span('mcem.mstep', it=1):\n    pass", 100_000)
    finally:
        tracing.disable()
        tracing.collect()
    return {"bare_ns": bare, "off_ns": off, "on_ns": on}


def install(spans: bool) -> dict:
    """Wrap the benchmark's tracer, breakdown and result line so that a
    traced run records the program's spans in its window (the recorder
    off throughout when ``spans`` is False) and leaves what they read in
    the returned dict."""
    from benchmark import run, trace
    from dvae_tpu_torch import tracing

    state = {}
    start, stop, breakdown, line = (trace.DeviceTrace.start, trace.DeviceTrace.stop,
                                    trace.breakdown, run.line)

    def traced_start(self):
        start(self)
        if spans:
            tracing.enable()

    def traced_stop(self):
        stop(self)
        tracing.disable()
        lo, hi = self.window
        state["program"] = [s for s in tracing.collect() if lo <= s.start_ns and s.end_ns <= hi]

    def traced_breakdown(events, window, probe_spans, top=10):
        program = state.get("program", [])
        state["readings"] = readings(program)
        state.update(named_gaps(breakdown, events, window, probe_spans, program, top))
        return breakdown(events, window, probe_spans, top)

    def traced_line(out, device):
        state["result"] = out["result"]
        state["traced_end_to_end"] = out["notes"].get("traced_end_to_end")
        state["device"] = device
        return line(out, device)

    trace.DeviceTrace.start, trace.DeviceTrace.stop = traced_start, traced_stop
    trace.breakdown, run.line = traced_breakdown, traced_line
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)
    if args.span_cost:
        print(json.dumps(span_cost()), flush=True)
        return 0
    from benchmark import run

    state = install(bool(args.spans))
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    res = state["result"]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "spans": args.spans,
        "correct": res["correct"], "end_to_end": state["traced_end_to_end"],
        "device": state["device"], "window_spans": len(state.get("program", [])),
        "readings": state.get("readings"), "idle_gaps": state.get("idle_gaps"),
        "gaps_in_program_span": state.get("gaps_in_program_span"),
        "gaps_named_by_program": state.get("gaps_named_by_program"),
        "probe_gaps": res.get("breakdown", {}).get("idle_gaps"),
        "per_layer": {k: v["value"] for k, v in res["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The device's side of a traced run: ``torch.profiler`` over the window
(CUDA activity only, so the host's operators add no events), reduced to
the device's busy time, its idle gaps and the time of each kernel."""

from __future__ import annotations

import collections
import time


class DeviceTrace:
    """Profiles the card from :meth:`start` to :meth:`stop` (after a
    synchronize)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # a CPU-only build has no CUDA activity: it profiles the host and
        # finds no device event
        act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
        self._prof = profile(activities=[act])
        self.events: list = []
        self.window = (0, 0)

    def start(self) -> None:
        self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        self.window = (self._t0, t1)
        self.events = [(e.name(), e.start_ns(), e.duration_ns())
                       for e in self._prof.profiler.kineto_results.events()
                       if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]


def busy_intervals(events) -> list:
    """The union of the events' [start, end) intervals, in order."""
    spans = sorted((s, s + d) for _, s, d in events)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_ns(events, window) -> int:
    lo, hi = window
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in busy_intervals(events))


def kernel_ns(events, part: str) -> int:
    """Summed device time of the kernels whose name holds ``part``."""
    return sum(d for n, _, d in events if part in n)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity,
    template and argument lists."""
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    cut = min((i for i in (base.find("<"), base.find("(")) if i > 0), default=len(base))
    return base[:cut][-120:]


def breakdown(events, window, spans, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the host span (``spans``: name -> [(start, end)]) open at
    the gap's start ("host" where none is)."""
    per = collections.Counter()
    for n, _, d in events:
        per[short_name(n)] += d
    ops = [[k, v / 1e9] for k, v in per.most_common(top)]
    lo, hi = window
    gaps, last = [], lo
    for s, e in busy_intervals(events) + [[hi, hi]]:
        s, e = max(s, lo), min(e, hi)
        if s > last:
            gaps.append((s - last, last))
        last = max(last, e)
    gaps.sort(reverse=True)
    named = []
    for length, at in gaps[:top]:
        owner = "host"
        best = None
        for name, ivs in spans.items():
            for a, b in ivs:
                if a <= at < b and (best is None or a > best):
                    best, owner = a, f"host.{name}"
        named.append([owner, length / 1e9])
    return {"device_ops": ops, "idle_gaps": named}

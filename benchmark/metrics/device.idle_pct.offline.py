"""Share of the traced window in which no operation ran on the card
(``torch.profiler``'s device timeline)."""

from benchmark.trace import busy_ns


def read(run):
    lo, hi = run.trace_window
    if hi <= lo or not run.events:
        return None
    return 100.0 * (1.0 - busy_ns(run.events, run.trace_window) / (hi - lo))

"""The NMF M-step's share of its roofline: the least time of each call
(``work.m_step_work`` at its R, B, N, F and sample dtype, at the f32 and
HBM peaks) over its time between CUDA events recorded around the call."""

from benchmark import work


def read(run):
    bound = spent = 0.0
    for (start, end), (r, b, n, f, vs_bytes) in run.mstep_events:
        bound += work.bound_ms(*work.m_step_work(r, b, n, f, vs_bytes))[0]
        spent += start.elapsed_time(end)
    return 100.0 * bound / spent if spent > 0 else None

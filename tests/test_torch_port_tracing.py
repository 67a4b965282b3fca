"""The port's span recorder (``dvae_tpu_torch.tracing``) and the spans the
enhancement path records: off by default, nested at the layer boundaries,
the EM stages once per iteration, each request's wait in the service's
queue; and ``tools/span_readings.py``, which reads them over a traced
benchmark run. Imports nothing of JAX; the test marked ``cuda`` (the
recorder's clock against ``torch.profiler``'s device events) skips without
a card:

    python -m pytest --noconftest -p no:cacheprovider -q -s -m cuda tests/test_torch_port_tracing.py
"""

import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dvae_tpu_torch import tracing
from dvae_tpu_torch.enhance.labeling import self_soft_labels
from dvae_tpu_torch.enhance.mcem import McemConfig
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models import VAE, DisentangledVAE
from dvae_tpu_torch.serving import EnhanceService, ServeConfig
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import span_readings  # noqa: E402
from benchmark import harness, run, spec, trace  # noqa: E402

NITER = 3
MCEM = McemConfig(niter=NITER, nsamples_e_step=2, burnin_e_step=2, nsamples_wf=2, burnin_wf=2)

#: each span of the enhancement path -> the span open around it
PARENTS = {
    "enhancer.prepare": "enhancer.dispatch",
    "enhancer.upload": "enhancer.dispatch",
    "enhancer.enqueue": "enhancer.dispatch",
    "mcem.estep": "enhancer.enqueue",
    "mcem.mstep": "enhancer.enqueue",
    "mcem.cost": "enhancer.enqueue",
    "mcem.wiener": "enhancer.enqueue",
    "enhancer.collect.wait": "enhancer.collect",
    "enhancer.collect.finish": "enhancer.collect",
    "enhancer.dispatch": None,
    "enhancer.collect": None,
    "labels": None,
}


def _wavs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.3 * np.sin(2 * np.pi * 200 * np.arange(n) / 16000)
             + 0.05 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def _model(cls=VAE, *args):
    torch.manual_seed(0)
    return cls(513, *args, 4, (16, 16))


def _inside(outer, inner) -> bool:
    return (outer.thread == inner.thread and outer.start_ns <= inner.start_ns
            and inner.end_ns <= outer.end_ns)


@pytest.fixture
def recorder():
    """The recorder on for the test, off and empty after it."""
    tracing.collect()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.collect()


def test_off_the_recorder_records_nothing():
    enh = Enhancer(_model(), EnhancerConfig(mcem=MCEM), device="cpu")
    out = enh.enhance_batch(_wavs((4000, 3000)), seed=1)
    assert len(out) == 2
    assert tracing.collect() == []
    assert tracing.span("a") is tracing.span("b", 5, it=1)  # one shared no-op
    assert tracing.clock() == 0
    tracing.record("c", 123, 456)
    assert tracing.collect() == []


def test_a_stream_gives_every_span_nested_once_per_iteration(recorder):
    model = _model(DisentangledVAE, 1)
    enh = Enhancer(model, EnhancerConfig(mcem=MCEM, y_mode="dec_only"), device="cpu")
    stft = enh.cfg.stft

    def batches():
        for k in range(2):
            ws = _wavs((5000, 3500, 2000), seed=k)
            yield ws, self_soft_labels(model, ws, stft, 1, "classify_from_x"), None

    outs = list(enh.enhance_stream(batches(), seed=3))
    assert [len(o) for o in outs] == [3, 3]
    spans = tracing.collect()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert set(by) == set(PARENTS)
    for s in spans:
        assert s.parent == PARENTS[s.name], s
        assert s.start_ns <= s.end_ns
        assert s.thread == threading.get_ident()
    assert len(by["labels"]) == 2 and all(s.attrs["utterances"] == 3 for s in by["labels"])
    dispatches, collects = by["enhancer.dispatch"], by["enhancer.collect"]
    assert [d.attrs["batch"] for d in dispatches] == [0, 1]
    assert all(d.attrs["utterances"] == 3 and d.attrs["n_pad"] == 64 for d in dispatches)
    # both batches are in flight before the first is collected, and each
    # collect names the batch it collects
    assert [c.attrs["batch"] for c in collects] == [0, 1]
    assert collects[0].start_ns >= dispatches[1].end_ns
    for d in dispatches:
        parts = sorted((s for name in ("enhancer.prepare", "enhancer.upload", "enhancer.enqueue")
                        for s in by[name] if _inside(d, s)), key=lambda s: s.start_ns)
        assert [s.name for s in parts] == ["enhancer.prepare", "enhancer.upload",
                                           "enhancer.enqueue"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
        enqueue = parts[-1]
        for stage in ("mcem.estep", "mcem.mstep", "mcem.cost"):
            its = [s.attrs["it"] for s in by[stage] if _inside(enqueue, s)]
            assert its == list(range(NITER)), stage
        assert sum(_inside(enqueue, s) for s in by["mcem.wiener"]) == 1
    for c in collects:
        wait, finish = ([s for s in by[name] if _inside(c, s)]
                        for name in ("enhancer.collect.wait", "enhancer.collect.finish"))
        assert len(wait) == len(finish) == 1 and wait[0].end_ns <= finish[0].start_ns


def test_the_service_records_each_request_s_wait_in_its_queue(recorder):
    svc = EnhanceService(_model(), "m1", EnhancerConfig(mcem=MCEM),
                         ServeConfig(batch_size=2, batch_window_ms=30.0, warmup_buckets=()),
                         device="cpu")
    n = 5
    answers = [None] * n

    def client(i):
        answers[i] = svc.submit(_wavs((2000 + 300 * i,), seed=i)[0], timeout=120)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
    finally:
        svc.close()
    stats = svc.stats_snapshot()  # the worker has stopped: every batch is counted
    assert all(a is not None for a in answers)
    spans = tracing.collect()
    queue = [s for s in spans if s.name == "service.queue"]
    dispatch = {s.attrs["batch"]: s for s in spans if s.name == "service.dispatch"}
    gather = {s.attrs["batch"]: s for s in spans if s.name == "service.gather"}
    finish = {s.attrs["batch"]: s for s in spans if s.name == "service.finish"}
    assert len(queue) == n
    assert set(dispatch) == set(gather) == set(finish) == {s.attrs["batch"] for s in queue}
    assert len(dispatch) == stats["batches"]
    for s in queue:
        assert s.start_ns <= s.end_ns <= dispatch[s.attrs["batch"]].start_ns
        assert s.end_ns == gather[s.attrs["batch"]].end_ns
    for b, d in dispatch.items():
        assert d.end_ns <= finish[b].end_ns
        inner = [s for s in spans if s.name == "enhancer.dispatch" and _inside(d, s)]
        assert len(inner) == 1 and inner[0].parent == "service.dispatch"
        assert any(s.name == "enhancer.collect" and s.parent == "service.finish"
                   and _inside(finish[b], s) for s in spans)
    # the stats' busy time runs from each dispatch's start to the end of its finish
    busy = sum(finish[b].end_ns - d.start_ns for b, d in dispatch.items()) / 1e9
    assert stats["busy_seconds"] == pytest.approx(busy, rel=1e-9)


def test_collect_empties_the_bounded_buffer(recorder, monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 5)
    tracing.enable()
    for i in range(12):
        with tracing.span("s", i=i) as sp:
            sp.set(j=-i)
    got = tracing.collect()
    assert [s.attrs for s in got] == [{"i": i, "j": -i} for i in range(7, 12)]
    assert tracing.collect() == []
    # a span recorded whole from two readings, one taken on another thread
    box = []
    th = threading.Thread(target=lambda: box.append(tracing.clock()))
    th.start()
    th.join(10)
    tracing.record("wait", box[0], None, k=1)
    tracing.record("never", 0, None)  # a start read while the recorder was off
    (s,) = tracing.collect()
    assert (s.name, s.parent, s.attrs) == ("wait", None, {"k": 1})
    assert box[0] <= s.end_ns


def _span(name, a, b, thread=1, **attrs):
    """A span from ``a`` to ``b`` ms."""
    return tracing.Span(name, int(a * 1e6), int(b * 1e6), thread, None, attrs)


SYNTHETIC = [
    _span("enhancer.dispatch", 0, 100, batch=0),
    _span("enhancer.prepare", 0, 10), _span("enhancer.upload", 10, 40),
    _span("enhancer.enqueue", 40, 99),
    _span("mcem.mstep", 50, 60, it=0), _span("mcem.mstep", 70, 74, it=1),
    _span("mcem.mstep", 80, 90, it=2),
    _span("enhancer.dispatch", 100, 300, batch=1),
    _span("enhancer.prepare", 100, 110), _span("enhancer.upload", 110, 200),
    _span("enhancer.enqueue", 200, 300),
    _span("enhancer.collect", 300, 400, batch=0),
    _span("enhancer.collect.wait", 301, 350), _span("enhancer.collect.finish", 350, 400),
    _span("enhancer.collect", 400, 420, batch=1),
    _span("enhancer.collect.wait", 400, 405), _span("enhancer.collect.finish", 405, 420),
    _span("enhancer.enqueue", 40, 99, thread=2),  # another thread's: in no dispatch
    _span("labels", 0, 3, thread=3), _span("labels", 10, 15, thread=3),
    *(_span("service.queue", 0, d, thread=4) for d in (10, 20, 30, 40, 50)),
]


def test_the_span_readings_of_a_worked_example():
    r = span_readings.readings(SYNTHETIC)
    assert r["host.enqueue_ms"] == pytest.approx(79.5)          # median of 59, 100
    assert r["partition_median"] == pytest.approx(0.995)      # 99/100, 200/200
    assert r["partition_min"] == pytest.approx(0.99)
    assert r["host.sync_wait_ms"] == pytest.approx(87)        # 30 + 49, 90 + 5
    assert (r["upload_ms"], r["collect_wait_ms"]) == (pytest.approx(60), pytest.approx(27))
    assert r["mstep.host_ms"] == pytest.approx(10)
    assert r["labels_ms"] == pytest.approx(4)
    assert r["serve.queue_wait_p95_ms"] == pytest.approx(48)
    assert r["requests"] == 5 and r["count"]["enhancer.enqueue"] == 3
    assert span_readings.readings([]) == {"median_ms": {}, "count": {}}
    # idle gaps from 320 ms (inside the wait for batch 0) and from 480 ms
    # (after the last program span, inside the probe's own span)
    events = [("k", 0, int(320e6)), ("k", int(330e6), int(150e6))]
    got = span_readings.named_gaps(trace.breakdown, events, (0, int(500e6)),
                                   {"collect": [(int(295e6), int(490e6))]}, SYNTHETIC)
    assert got == {"idle_gaps": [["host.collect", 0.02], ["host.enhancer.collect.wait", 0.01]],
                   "gaps_in_program_span": 1, "gaps_named_by_program": 1}


def _small(name):
    """The benchmark cell ``name`` at a size a CPU test holds."""
    cell = spec.load_cell(name)
    cell.config["mcem"]["niter"] = 2
    cell.traffic.update(pool=4, min_s=1.0, max_s=1.4, batch=2)
    if cell.traffic["mode"] == "open_loop":
        cell.traffic["rate_per_s"] = 4.0
    cell.check["dispatch"] = [0, 1]
    return cell


@pytest.mark.parametrize("spans", [True, False], ids=["recorder-on", "recorder-off"])
def test_a_traced_cpu_run_reads_the_program_s_spans(monkeypatch, spans):
    for owner, attr in ((trace.DeviceTrace, "start"), (trace.DeviceTrace, "stop"),
                        (trace, "breakdown"), (run, "line")):
        monkeypatch.setattr(owner, attr, getattr(owner, attr))  # undone after the test
    state = span_readings.install(spans)
    out = harness.run(_small("m1.offline.sorted"), 2**31 + 11, 0.5, True, torch.device("cpu"),
                      time.monotonic())
    assert out["result"]["correct"], out["checks"]
    count = state["readings"]["count"]
    if spans:
        assert count["enhancer.dispatch"] == count["enhancer.collect"] >= 1
        assert count["mcem.mstep"] == 2 * count["enhancer.dispatch"]
        assert state["readings"]["partition_min"] > 0.9
    else:
        assert count == {}
    assert tracing.collect() == [] and tracing.span("x") is tracing.span("y")
    # an untraced run never switches the recorder on
    harness.run(_small("m1.offline.sorted"), 5, 0.2, False, torch.device("cpu"),
                time.monotonic())
    assert tracing.collect() == [] and tracing.span("x") is tracing.span("y")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's profiler events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_a_span_contains_its_kernel_on_the_profilers_clock(cuda, recorder):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("sleep"):
            torch.cuda._sleep(50_000_000)  # cycles: ~25 ms at the H100's clock
            torch.cuda.synchronize()
    (s,) = tracing.collect()
    events = [e for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]
    k = max(events, key=lambda e: e.duration_ns())
    start, end = k.start_ns(), k.start_ns() + k.duration_ns()
    print(f"\nspan {s.start_ns}..{s.end_ns}, kernel {k.name()} {start}..{end}: "
          f"opens {(start - s.start_ns) / 1e3:.1f} us after the span, "
          f"ends {(s.end_ns - end) / 1e3:.1f} us before it")
    assert k.duration_ns() > 5_000_000
    assert s.start_ns <= start and end <= s.end_ns

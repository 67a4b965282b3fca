"""The general traffic generator: one runner per traffic ``mode``, each
reading only the parameters of a ``traffic/<name>.json`` file.

- ``batches``: a pool of mixtures cut into fixed batches, fed back to back
  through ``Enhancer.enhance_stream`` (the sweeps' path) and cycled until
  the window has passed; the conditioned configurations label each batch
  first (``self_soft_labels``, or the configuration's label network on the
  batch's mixtures and side inputs), inside the window.
- ``open_loop``: requests sent at their due times through
  ``EnhanceService.submit``, each from its own client thread with its
  mixture's side inputs as keyword arguments; the gaps between due times
  are the quantiles of an exponential draw at the traffic's rate, in an
  order drawn from the seed.

Either way the set of lengths (and of gaps) is the same for every seed, so
a seed changes the audio and the order, never the work. The ``shuffled``
order is a uniform permutation drawn from the seed: every ordering of the
set is as likely, so runs of short gaps and of long utterances come as
often as under independent draws (Poisson arrivals).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchmark import synth


def ordered(values: np.ndarray, traffic: dict, rng: np.random.Generator) -> np.ndarray:
    """``values`` (ascending) in the traffic's ``order``: "sorted" or
    "shuffled" (a permutation drawn from ``rng``)."""
    order = traffic["order"]
    if order == "sorted":
        return values
    if order == "shuffled":
        return values[rng.permutation(len(values))]
    raise ValueError(f"bad order {order!r}")


def pool(traffic: dict, seed: int, device, st, inputs=()) -> tuple[list, dict]:
    """The traffic's pool of mixtures: ``pool`` lengths on the uniform grid
    of [min_s, max_s], in the traffic's order; and ``{input: [one per
    mixture]}`` of the side ``inputs`` the configuration declares
    ("video": :func:`synth.lip_video`, a crop per frame of the STFT
    ``st``)."""
    lengths = synth.length_grid(traffic["pool"], traffic["min_s"], traffic["max_s"], st.fs)
    lengths = ordered(lengths, traffic, np.random.default_rng([seed, 0]))
    wavs, rates = synth.speech(lengths, seed, device, st.fs)
    side = {}
    for name in inputs:
        if name != "video":
            raise ValueError(f"bad side input {name!r}")
        side[name] = synth.lip_video([st.frames(n) for n in lengths], rates, seed, device,
                                     st.hop / st.fs, st.nfft / st.fs)
    return wavs, side


def due_times(traffic: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``rate_per_s`` x
    ``seconds`` requests: the gaps are an exponential draw's quantiles at
    that rate (Poisson arrivals with a fixed set of gaps), in the traffic's
    order."""
    rate = float(traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)[::-1] / rate
    gaps = ordered(np.ascontiguousarray(gaps), traffic, np.random.default_rng([seed, 1]))
    return np.cumsum(gaps) - gaps[0]


class Batches:
    """The ``batches`` mode over an ``Enhancer``."""

    def __init__(self, enhancer, traffic: dict, wavs, labeler=None, side=None):
        self.enh = enhancer
        b = int(traffic["batch"])
        starts = range(0, len(wavs), b)
        self.batches = [wavs[i:i + b] for i in starts]
        self.sides = [{k: v[i:i + b] for k, v in (side or {}).items()} for i in starts]
        self.labeler = labeler  # (wavs, side inputs) -> per-utterance labels

    def warm(self, warm_enhancer) -> None:
        """One pass of every batch shape through ``warm_enhancer`` (the
        same program at a short EM budget), labels included."""
        seen = set()
        for wavs, side in zip(self.batches, self.sides):
            shape = (len(wavs), max(len(w) for w in wavs))
            if shape in seen:
                continue
            seen.add(shape)
            ys = self.labeler(wavs, side) if self.labeler else None
            warm_enhancer.enhance_batch(wavs, ys, seed=0)

    def run(self, seconds: float, seed: int, probe, min_batches: int = 1) -> dict:
        """Feed batches until ``seconds`` have passed (and at least
        ``min_batches``), then drain. Returns the fed batches, the answers of
        the recorded one and the window's start and end."""
        fed, answers = [], {}
        t0 = time.monotonic()

        def feed():
            i = 0
            while i < min_batches or time.monotonic() - t0 < seconds:
                wavs = self.batches[i % len(self.batches)]
                ys = None
                if self.labeler:
                    a = time.time_ns()
                    ys = self.labeler(wavs, self.sides[i % len(self.batches)])
                    probe.span("labels", a, time.time_ns())
                fed.append(wavs)
                yield wavs, ys, None
                i += 1

        for k, out in enumerate(self.enh.enhance_stream(feed(), seed=seed)):
            if k == probe.target:
                answers[k] = out
            fed[k] = (fed[k], out)
        t1 = time.monotonic()
        return {"t0": t0, "t1": t1, "fed": fed, "answers": answers.get(probe.target)}


class OpenLoop:
    """The ``open_loop`` mode over an ``EnhanceService``."""

    def __init__(self, service, traffic: dict, requests, due, side=None):
        self.svc = service
        self.traffic = traffic
        self.requests = requests  # one array object per request
        self.due = due
        self.side = side or [{}] * len(due)  # each request's side inputs, by name

    def run(self, seconds: float) -> dict:
        """Send every request at its due time; wait for all (at most
        ``drain_s`` past the last due time). Latency runs from the due time
        to the answer; a refused or failed request has none."""
        due, n = self.due, len(self.due)
        done = [None] * n
        answers = [None] * n
        errors = [None] * n
        sent_late = np.zeros(n)
        timeout = float(self.traffic["drain_s"]) + seconds
        threads = []
        t0 = time.monotonic()

        def client(i, wav):
            try:
                answers[i] = self.svc.submit(wav, timeout=timeout, **self.side[i])
                done[i] = time.monotonic()
            except Exception as e:  # counted as failed; never an answer
                errors[i] = repr(e)

        for i in range(n):
            wait = t0 + due[i] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            sent_late[i] = time.monotonic() - (t0 + due[i])
            th = threading.Thread(target=client, args=(i, self.requests[i]),
                                  daemon=True)
            th.start()
            threads.append(th)
        t_sent = time.monotonic()
        for th in threads:
            th.join(max(0.0, t_sent + float(self.traffic["drain_s"]) - time.monotonic()))
        t1 = time.monotonic()
        lat = [d - (t0 + due[i]) if d is not None else float("inf") for i, d in enumerate(done)]
        return {"t0": t0, "t1": t1, "latency": lat, "answers": answers, "errors": errors,
                "late_max_s": float(sent_late.max()), "alive": sum(t.is_alive() for t in threads)}

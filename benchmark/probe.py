"""Wrappers the benchmark installs around the program's stage entry points
for one run.

Two jobs. For ``correct``: while the window is open, the dispatch drawn
from the seed is recorded stage by stage (the engine's inputs and result,
the chain segments and M-steps of the drawn EM iterations, the Wiener
segment, the self-soft labels' power), so that the reference can follow
the program from its own state after the window; and of every EM
iteration of that dispatch the state each stage was handed and handed on
(the latents, the gains, W and H; the Vb plane after each drawn
iteration), so that the check can tell that each stage fed the next for
all ``niter`` iterations. For a traced run: host
spans around dispatch, collect and the labels, the parameters of every
chain launch and power launch, and CUDA events around each M-step.

Every wrapper calls through to the program's own function; none changes
what it computes.
"""

from __future__ import annotations

import collections
import time

import torch


def _clone(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


class Probe:
    """The run's wrappers and what they gathered. ``target`` is the index,
    counted from the window's start, of the dispatch recorded for the
    check, ``iterations`` its EM iterations whose E-step and M-step are
    recorded; ``trace`` adds the spans, launches and events."""

    def __init__(self, target: int, iterations, trace: bool):
        self.target = target
        self.iterations = set(iterations)
        self.trace = trace
        self.window_open = False
        self.dispatches = 0
        self.recording = False
        self.record: dict = {}
        self.spans = collections.defaultdict(list)
        self.chain_calls: list = []
        self.mstep_events: list = []
        self.power_calls: list = []
        self._last_power = None
        self._undo: list = []

    # -- installing ------------------------------------------------------------
    def _patch(self, owner, name: str, wrapper, item: bool = False):
        orig = owner[name] if item else getattr(owner, name)
        if item:
            owner[name] = wrapper(orig)
            self._undo.append(lambda: owner.__setitem__(name, orig))
        else:
            setattr(owner, name, wrapper(orig))
            self._undo.append(lambda: setattr(owner, name, orig))

    def install(self, enhancer, service=None) -> None:
        from dvae_tpu_torch.enhance import labeling, mcem, pipeline

        self._patch(enhancer, "_dispatch", self._wrap_dispatch)
        self._patch(enhancer, "_collect", self._span_wrapper("collect"))
        self._patch(pipeline.ENGINES, enhancer.cfg.engine, self._wrap_engine, item=True)
        self._patch(mcem, "run_mh_chain", self._wrap_chain)
        self._patch(mcem, "nmf_m_step", self._wrap_mstep)
        self._patch(labeling, "power_spectrogram", self._wrap_power)
        if service is not None:
            self._patch(service, "_labels_for_batch", self._span_wrapper("labels"))
            self._patch(service, "_gather_batch", self._span_wrapper("gather"))

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def span(self, name: str, t0: int, t1: int) -> None:
        """A host span (unix ns, the profiler's clock), kept in traced runs
        while the window is open."""
        if self.trace and self.window_open:
            self.spans[name].append((t0, t1))

    def _span_wrapper(self, name: str):
        def wrap(orig):
            def call(*a, **k):
                t0 = time.time_ns()
                try:
                    return orig(*a, **k)
                finally:
                    self.span(name, t0, time.time_ns())
            return call
        return wrap

    # -- wrappers ----------------------------------------------------------------
    def _wrap_dispatch(self, orig):
        def dispatch(wavs, ys, seed, max_frames, clean_wavs=None):
            t0 = time.time_ns()
            rec = False
            if self.window_open:
                rec = self.dispatches == self.target and not self.record
                self.dispatches += 1
            if rec:
                self.recording = True
                self.record.update(wavs=list(wavs), ys=ys, estep={}, mstep={},
                                   power=self._last_power, chain_log=[], mstep_log=[],
                                   wf_calls=0)
            try:
                return orig(wavs, ys, seed, max_frames, clean_wavs)
            finally:
                if rec:
                    self.recording = False
                self.span("dispatch", t0, time.time_ns())
        return dispatch

    def _wrap_engine(self, orig):
        def engine(mats, x2, z_init, mask, seed=0, cfg=None, y=None, nmf_init=None):
            if self.recording:
                self.record["engine_in"] = _clone(dict(x2=x2, z=z_init, mask=mask, y=y))
            res = orig(mats, x2, z_init, mask, seed, cfg, y=y, nmf_init=nmf_init)
            if self.recording:
                self.record["engine_out"] = _clone(dict(wfs=res.wfs, wfn=res.wfn))
            return res
        return engine

    def _wrap_chain(self, orig):
        def chain(mats, x2, vb, g, z, y, noise, n_burn, n_samples, var_rw, wf_mode=False,
                  fast_decoder=False, fast_stats=False):
            if self.trace and self.window_open:
                self.chain_calls.append((x2.shape[0], x2.shape[1], z.shape[-1], mats.widths,
                                         n_burn, n_samples, wf_mode, fast_stats, fast_decoder))
            keep = link = None
            if self.recording:
                it = None if wf_mode else len(self.record["chain_log"])
                if wf_mode:
                    self.record["wf_calls"] += 1
                else:
                    link = _clone(dict(z=z, g=g))
                    if it - 1 in self.iterations:
                        link["vb"] = _clone(vb)
                    self.record["chain_log"].append(link)
                if wf_mode or it in self.iterations:
                    keep = dict(x2=x2, vb=vb, g=g, z=z, y=y, noise=noise, n_burn=n_burn,
                                n_samples=n_samples, var_rw=var_rw, fast_decoder=fast_decoder,
                                fast_stats=fast_stats)
                    keep = _clone(keep)
            out = orig(mats, x2, vb, g, z, y, noise, n_burn, n_samples, var_rw, wf_mode,
                       fast_decoder, fast_stats)
            if link is not None:
                link["z_out"] = _clone(out[0])
            if keep is not None:
                keep["out"] = _clone(out)
                if wf_mode:
                    self.record["wf"] = keep
                else:
                    self.record["estep"][it] = keep
            return out
        return chain

    def _wrap_mstep(self, orig):
        def m_step(x2, vs, w, h, g, mask, eps=1e-8):
            keep = link = None
            if self.recording:
                it = len(self.record["mstep_log"])
                link = {"in": _clone((w, h, g))}
                self.record["mstep_log"].append(link)
                if it in self.iterations:
                    keep = _clone(dict(x2=x2, vs=vs, w=w, h=h, g=g, mask=mask, eps=eps))
            timed = self.trace and self.window_open and x2.is_cuda
            if timed:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = orig(x2, vs, w, h, g, mask, eps)
            if timed:
                ev[1].record()
                self.mstep_events.append((ev, (vs.shape[0], *x2.shape, vs.element_size())))
            if link is not None:
                link["out"] = _clone(tuple(out[:3]))
            if keep is not None:
                keep["out"] = _clone(out)
                self.record["mstep"][it] = keep
            return out
        return m_step

    def _wrap_power(self, orig):
        def power(x, cfg):
            out = orig(x, cfg)
            if self.window_open:
                self._last_power = (x, out)
                if self.trace:
                    lead = x.shape[0] if x.dim() > 1 else 1
                    self.power_calls.append((lead * out.shape[-2], x.numel(), cfg.nfft,
                                             out.shape[-1]))
            return out
        return power

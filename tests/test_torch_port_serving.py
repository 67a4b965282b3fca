"""The port's HTTP serving package ``dvae_tpu_torch.serving`` on the CPU,
against the JAX package's ``dvae_tpu.serving`` where both can be asked.

Parity with the JAX package: the wire helpers are byte-equal on the same
inputs; a service's Prometheus text has the same metric names (fresh and
after a request); the port's service and the JAX ``EnhanceService``, given
the same request with a frozen chain (var_rw = 0, f32 decoders), the same
NMF init and the float32 wire, agree to 1e-4 of the peak, short and
chunked; the HTTP routes give the same status codes (and Retry-After) for
the same requests, bad ones included.

The port alone: micro-batching into fixed-size batches with
``fold_seed(seed, k)`` seeds, self-soft labels on the worker thread, hot
reload, drain, warmup readiness and failure, the chunked and streamed
paths, a worker that survives a bad batch, and that ``boot.py`` imports
only the standard library.

No test asserts on timing or arrival order; every request, join and wait
has a timeout, and every service and server is closed in ``finally``.
"""

from __future__ import annotations

import ast
import contextlib
import http.client
import importlib.util
import io
import json
import pathlib
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import dvae_tpu.enhance.mcem as jmcem
import dvae_tpu.serving as jserving
import dvae_tpu_torch.enhance.mcem as tmcem
import dvae_tpu_torch.serving as tserving
import dvae_tpu_torch.serving.service as tservice
from dvae_tpu.enhance.mcem import McemConfig as JaxMcemConfig
from dvae_tpu.enhance.pipeline import EnhancerConfig as JaxEnhancerConfig
from dvae_tpu.models import VAE as JaxVAE
from dvae_tpu.models import init_params
from dvae_tpu_torch.enhance.longform import chunk_spans
from dvae_tpu_torch.enhance.mcem import McemConfig, fold_seed
from dvae_tpu_torch.enhance.pipeline import EnhancerConfig
from dvae_tpu_torch.models import CVAE, VAE, DisentangledVAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.serving import (
    EnhancementError,
    EnhanceService,
    ServeConfig,
    ServiceOverloaded,
)
from dvae_tpu_torch.serving.http import platform_of
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
QUICK = dict(niter=3, nsamples_e_step=2, burnin_e_step=2, nsamples_wf=3, burnin_wf=3)
FROZEN = dict(niter=2, nsamples_e_step=2, burnin_e_step=1, nsamples_wf=2, burnin_wf=1,
              var_rw=0.0)
TIMEOUT = 120


def _noisy(seconds=0.6, fs=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    return (0.4 * np.sin(2 * np.pi * 210 * t) + 0.1 * rng.standard_normal(len(t))).astype(
        np.float32)


def _wav_body(x, fs=16000):
    buf = io.BytesIO()
    wavfile.write(buf, fs, np.clip(np.rint(np.asarray(x, np.float64) * 32768.0),
                                   -32768, 32767).astype(np.int16))
    return buf.getvalue()


def _post(url, body, timeout=TIMEOUT):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers, r.read()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _partition_ok(s, n, x, tol=5e-3):
    return len(s) == len(n) == len(x) and np.median(np.abs(s + n - x)[: len(x) - 1024]) < tol


def _tmodel(seed=0, cls=VAE, *args):
    torch.manual_seed(seed)
    return cls(513, *args, 4, (16, 16)) if args else cls(513, 4, (16, 16))


def _service(model=None, model_class="m1", enh=None, **cfg_kw) -> EnhanceService:
    kw = dict(batch_size=2, batch_window_ms=5.0, warmup_buckets=(), max_audio_seconds=30.0)
    kw.update(cfg_kw)
    return EnhanceService(model if model is not None else _tmodel(), model_class,
                          enh_cfg=enh or EnhancerConfig(mcem=McemConfig(**QUICK)),
                          cfg=ServeConfig(**kw), device="cpu")


def _jax_model():
    jm = JaxVAE(x_dim=513, z_dim=4, h_dim=(16, 16))
    params = init_params(jm, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                         np.ones((4, 513), np.float32))
    return jm, params


def _jax_service(enh=None, **cfg_kw):
    kw = dict(batch_size=2, batch_window_ms=5.0, warmup_buckets=(), max_audio_seconds=30.0)
    kw.update(cfg_kw)
    jm, params = _jax_model()
    return jserving.EnhanceService(jm, params, "m1",
                                   enh_cfg=enh or JaxEnhancerConfig(mcem=JaxMcemConfig(**QUICK)),
                                   cfg=jserving.ServeConfig(**kw))


@contextlib.contextmanager
def serving(svc, server_mod=None, **kw):
    """Serve ``svc`` on a free loopback port for the block; the server and
    the service are closed however the block ends."""
    srv = (server_mod or tserving).make_server(svc, "127.0.0.1", 0, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        t.join(timeout=10)


def _settle(*services):
    """Wait until every admitted item is fully processed: the worker
    updates the batch and utterance counters after it answers the
    waiters."""
    deadline = time.monotonic() + TIMEOUT
    while any(svc._unfinished for svc in services) and time.monotonic() < deadline:
        time.sleep(0.005)


def _park(svc):
    """Stop the worker so queued items stay queued."""
    svc._stop.set()
    svc._worker.join(timeout=10)
    assert not svc._worker.is_alive()


def _unpark(svc):
    svc._stop.clear()
    svc._worker = threading.Thread(target=svc._run, daemon=True, name="enhance-worker")
    svc._worker.start()


# ---------------------------------------------------------------- wire parity
def _encodings():
    rng = np.random.default_rng(0)
    return {
        "int16": (rng.standard_normal(1000) * 8000).astype(np.int16),
        "int16-stereo": (rng.standard_normal((1000, 2)) * 8000).astype(np.int16),
        "int32": (rng.standard_normal(500) * 1e8).astype(np.int32),
        "uint8": rng.integers(0, 255, 500).astype(np.uint8),
        "float32": rng.standard_normal(500).astype(np.float32) * 0.5,
        "float32-3ch": rng.standard_normal((400, 3)).astype(np.float32) * 0.5,
        "float64": rng.standard_normal(300) * 0.5,
    }


@pytest.mark.parametrize("enc", list(_encodings()))
def test_wire_decode_matches_jax(enc):
    buf = io.BytesIO()
    wavfile.write(buf, 16000, _encodings()[enc])
    body = buf.getvalue()
    got, fs = tserving._parse_wav_bytes(body)
    want, fs_j = jserving._parse_wav_bytes(body)
    assert fs == fs_j == 16000 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    tinfo = tserving._riff_stream_info(io.BytesIO(body), len(body))
    jinfo = jserving._riff_stream_info(io.BytesIO(body), len(body))
    assert tinfo == jinfo and tinfo[1] is not None
    consumed, info = tinfo
    data = body[len(consumed):len(consumed) + info["data_bytes"]]
    args = (data, info["fmt"], info["bits"], info["channels"])
    mono = tserving._pcm_to_float_mono(*args)
    np.testing.assert_array_equal(mono, jserving._pcm_to_float_mono(*args))
    np.testing.assert_array_equal(mono, want.astype(np.float32))


def _riff_variants():
    buf = io.BytesIO()
    wavfile.write(buf, 16000, (np.random.default_rng(1).standard_normal(256) * 8000)
                  .astype(np.int16))
    body = buf.getvalue()
    insert = body.index(b"data")
    listed = body[:insert] + b"LIST" + (4).to_bytes(4, "little") + b"INFO" + body[insert:]
    zeroed = bytearray(body)
    zeroed[insert + 4:insert + 8] = (0).to_bytes(4, "little")
    fmt24 = bytearray(body)
    bpos = body.index(b"fmt ") + 8
    fmt24[bpos + 14:bpos + 16] = (24).to_bytes(2, "little")
    return {"plain": body, "list-chunk": listed, "zero-size-data": bytes(zeroed),
            "24-bit": bytes(fmt24), "not-riff": b"NOTAWAV0" * 4, "truncated": body[:30]}


@pytest.mark.parametrize("variant", list(_riff_variants()))
def test_riff_stream_info_matches_jax(variant):
    body = _riff_variants()[variant]
    got = tserving._riff_stream_info(io.BytesIO(body), len(body))
    assert got == jserving._riff_stream_info(io.BytesIO(body), len(body))
    assert (got[1] is None) == (variant in ("24-bit", "not-riff", "truncated"))


def test_riff_header_segments_and_wav_bytes_match_jax():
    for data_bytes, n_ch, fs in ((0, 1, 16000), (2 * 12345, 1, 16000), (4 * 999, 2, 8000)):
        assert tserving._riff_header(data_bytes, n_ch, fs) == jserving._riff_header(
            data_bytes, n_ch, fs)
    rng = np.random.default_rng(2)
    s, n = (rng.standard_normal(777) * 0.3).astype(np.float32), rng.standard_normal(777)
    s[:3] = (1.5, -1.5, 0.5 / 32768)  # clipping and a tie
    for want in ("speech", "noise", "stereo"):
        assert tserving._pcm_seg_bytes((s, n), want) == jserving._pcm_seg_bytes((s, n), want)
    for chans in ([s], [s, n]):
        assert tserving._wav_bytes(chans, 16000) == jserving._wav_bytes(chans, 16000)


def test_feed_helpers_match_jax():
    blocks = [np.arange(5, dtype=np.float32), np.arange(5, 12, dtype=np.float64)]
    np.testing.assert_array_equal(tserving._collect_feed(iter(blocks), 10),
                                  jserving._collect_feed(iter(blocks), 10))
    for mod in (tserving, jserving):
        with pytest.raises(ValueError, match="ended early: got 12 of 20"):
            mod._collect_feed(iter(blocks), 20)


# ------------------------------------------------------- service-level parity
def _metric_names(text):
    return sorted(line.split()[2] for line in text.splitlines() if line.startswith("# TYPE"))


def test_fresh_prometheus_text_has_the_jax_metric_names():
    tsvc, jsvc = _service(), _jax_service()
    try:
        ttext, jtext = tserving._prometheus_text(tsvc), jserving._prometheus_text(jsvc)
    finally:
        tsvc.close()
        jsvc.close()
    assert _metric_names(ttext) == _metric_names(jtext)
    assert "dvae_requests_total 0" in ttext and "dvae_rtf" not in ttext
    assert [k for k, *_ in tserving._PROM_COUNTERS] == [k for k, *_ in jserving._PROM_COUNTERS]


@pytest.fixture
def shared_nmf_init(monkeypatch):
    """Both packages' init_nmf return the same numpy-seeded (W, H, g)."""
    def draw(batch, n_frames, n_freq, rank, eps):
        rng = np.random.default_rng(batch * 1000 + n_frames)
        return (np.maximum(rng.uniform(size=(batch, n_freq, rank)), eps).astype(np.float32),
                np.maximum(rng.uniform(size=(batch, n_frames, rank)), eps).astype(np.float32),
                np.ones((batch, n_frames), np.float32))

    monkeypatch.setattr(jmcem, "init_nmf", lambda key, *a: tuple(map(jnp.asarray, draw(*a))))
    monkeypatch.setattr(tmcem, "init_nmf", lambda gen, *a, device=None: tuple(
        torch.from_numpy(m).to(device) for m in draw(*a)))


@pytest.mark.parametrize("kind", ["short", "chunked"])
def test_service_matches_jax_service_frozen_chain(shared_nmf_init, kind):
    """Same request, frozen chain, shared NMF init, float32 wire. Chunked:
    one chunk per batch (batch_size 1), so the batches are the same in both
    packages whatever the arrival order."""
    jm, params = _jax_model()
    tm = VAE(513, 4, (16, 16))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    cfg = (dict(batch_size=2) if kind == "short"
           else dict(batch_size=1, chunk_seconds=1.0))
    jsvc = jserving.EnhanceService(
        jm, params, "m1",
        enh_cfg=JaxEnhancerConfig(mcem=JaxMcemConfig(**FROZEN, fast_stats=False,
                                                     fast_decoder=False), wire_dtype="float32"),
        cfg=jserving.ServeConfig(warmup_buckets=(), batch_window_ms=5.0, **cfg))
    tsvc = _service(tm, enh=EnhancerConfig(
        mcem=McemConfig(**FROZEN, fast_stats=False, fast_decoder=False),
        wire_dtype="float32"), **cfg)
    try:
        x = _noisy(0.6 if kind == "short" else 2.6, seed=3)
        sj, nj = jsvc.submit(x, timeout=TIMEOUT)
        st, nt = tsvc.submit(x, timeout=TIMEOUT)
        assert st.shape == nt.shape == x.shape
        peak = np.abs(sj).max()
        np.testing.assert_allclose(st, sj, atol=1e-4 * peak)
        np.testing.assert_allclose(nt, nj, atol=1e-4 * peak)
        _settle(jsvc, tsvc)
        jst, tst = jsvc.stats_snapshot(), tsvc.stats_snapshot()
        for k in ("requests", "utterances", "batches", "failed", "rejected"):
            assert tst[k] == jst[k], k
        assert _metric_names(tserving._prometheus_text(tsvc)) == _metric_names(
            jserving._prometheus_text(jsvc))
    finally:
        jsvc.close()
        tsvc.close()


# ------------------------------------------------------- HTTP status parity
@pytest.fixture(scope="module")
def both_servers():
    """One port server and one JAX server over tiny M1 services."""
    with serving(_service()) as turl, serving(_jax_service(), jserving) as jurl:
        yield turl, jurl


def _raw(url, method, path, body=b"", headers=None):
    """(status, Retry-After present, body) of one request, written to the
    socket whole before the response is read (a server that answers before
    reading the body then closes cannot break the client's send)."""
    host, port = url.rsplit("/", 1)[-1].split(":")
    headers = {"Host": f"{host}:{port}", "Connection": "close", **(headers or {})}
    if headers.get("Transfer-Encoding") == "chunked":
        payload = f"{len(body):x}\r\n".encode() + body + b"\r\n0\r\n\r\n"
    else:
        payload = body
        headers.setdefault("Content-Length", str(len(body)))
    head = f"{method} {path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
    with socket.create_connection((host, int(port)), timeout=TIMEOUT) as sock:
        sock.sendall(head.encode() + payload)
        r = http.client.HTTPResponse(sock)
        r.begin()
        return r.status, r.getheader("Retry-After") is not None, r.read()


STATUS_CASES = {
    "healthz": ("GET", "/healthz", b"", None, 200),
    "stats": ("GET", "/stats", b"", None, 200),
    "metrics": ("GET", "/metrics", b"", None, 200),
    "unknown-get": ("GET", "/nope", b"", None, 404),
    "unknown-post": ("POST", "/nope", _wav_body(_noisy(0.3)), None, 404),
    "bad-wav": ("POST", "/enhance", b"not a wav file at all", None, 400),
    "wrong-rate": ("POST", "/enhance", _wav_body(_noisy(0.6, 8000), 8000), None, 400),
    "wrong-rate-resampled": ("POST", "/enhance?resample=1", _wav_body(_noisy(0.6, 8000), 8000),
                             None, 200),
    "bad-return": ("POST", "/enhance?return=sidechannel", _wav_body(_noisy(0.3)), None, 400),
    "bad-y-source": ("POST", "/enhance?y_source=gibbs", _wav_body(_noisy(0.3)), None, 400),
    "empty-body": ("POST", "/enhance", b"", None, 400),
    "over-cap": ("POST", "/enhance", _wav_body(np.zeros(16000 * 31, np.float32)), None, 400),
    "chunked-upload": ("POST", "/enhance", _wav_body(_noisy(0.3)),
                       {"Transfer-Encoding": "chunked"}, 411),
    "bad-content-length": ("POST", "/enhance", b"", {"Content-Length": "abc"}, 400),
    "reload-no-checkpoint": ("POST", "/reload", b"", None, 400),
    "reload-missing-file": ("POST", "/reload?checkpoint=/nonexistent/m.pt", b"", None, 400),
}


@pytest.mark.parametrize("case", list(STATUS_CASES))
def test_http_status_codes_match_jax(both_servers, case):
    method, path, body, headers, want = STATUS_CASES[case]
    turl, jurl = both_servers
    got_t, got_j = _raw(turl, method, path, body, headers), _raw(jurl, method, path, body, headers)
    assert got_t[:2] == got_j[:2] and got_t[0] == want, (got_t[:2], got_j[:2])
    if case == "wrong-rate-resampled":
        fs, data = wavfile.read(io.BytesIO(got_t[2]))
        assert fs == 16000 and abs(len(data) - 2 * int(0.6 * 8000)) <= 2


def test_full_queue_is_503_with_retry_after_in_both():
    got = []
    for svc, mod in ((_service(max_queue=1), tserving), (_jax_service(max_queue=1), jserving)):
        with serving(svc, mod) as url:
            _park(svc)
            svc._q.put_nowait(mod._Item(_noisy(0.3), None))
            got.append(_raw(url, "POST", "/enhance", _wav_body(_noisy(0.3)))[:2])
            assert svc.stats_snapshot()["rejected"] == 1
    assert got[0] == got[1] == (503, True)


def test_admin_token_codes_match_jax(tmp_path):
    torch.save(_tmodel().state_dict(), tmp_path / "m1.pt")
    results = []
    for svc, mod in ((_service(), tserving), (_jax_service(), jserving)):
        with serving(svc, mod, admin_token="s3cret") as url:
            results.append([
                _raw(url, "POST", f"/reload?checkpoint={tmp_path / 'm1.pt'}")[0],
                _raw(url, "POST", f"/reload?checkpoint={tmp_path / 'm1.pt'}&token=nope")[0],
                _raw(url, "POST", "/reload?checkpoint=/nonexistent/m.pt&token=s3cret")[0],
                _raw(url, "POST", "/enhance", _wav_body(_noisy(0.3)))[0],
            ])
    assert results[0] == results[1] == [403, 403, 400, 200]


# ------------------------------------------------------------- port service
def test_http_roundtrip_partition_and_platform():
    svc = _service(batch_size=4, warmup_buckets=(64,))
    svc.warmup()
    with serving(svc) as url:
        x = _noisy()
        status, headers, body = _post(f"{url}/enhance?return=stereo", _wav_body(x))
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        fs, data = wavfile.read(io.BytesIO(body))
        assert fs == 16000 and data.dtype == np.int16 and data.shape == (len(x), 2)
        assert _partition_ok(data[:, 0] / 32768.0, data[:, 1] / 32768.0, x)
        h = _get_json(f"{url}/healthz")
        assert h["status"] == "ok" and h["ready"] and h["platform"] == "cpu"
        assert h["warm_buckets"] == [64] and h["model_class"] == "m1"
        _settle(svc)
        st = _get_json(f"{url}/stats")
        assert st["requests"] == 1 and st["batches"] == 1 and st["rtf"] is not None
    assert platform_of(torch.device("cuda")) == "gpu"
    assert platform_of(torch.device("cpu")) == "cpu"


def test_concurrent_http_requests_are_all_answered():
    svc = _service(batch_size=4, batch_window_ms=40.0)
    with serving(svc) as url:
        xs = [_noisy(seed=i) for i in range(4)]
        results, errors = [None] * 4, []

        def post(i):
            try:
                results[i] = _post(f"{url}/enhance?return=stereo", _wav_body(xs[i]))
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not errors and not any(t.is_alive() for t in threads)
        _settle(svc)
        for (status, _, body), x in zip(results, xs):
            data = wavfile.read(io.BytesIO(body))[1]
            assert status == 200 and _partition_ok(data[:, 0] / 32768.0, data[:, 1] / 32768.0, x)
        st = svc.stats_snapshot()
        assert st["requests"] == st["utterances"] == 4 and 1 <= st["batches"] <= 4


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sequential"])
def test_microbatch_is_padded_to_batch_size_with_folded_seeds(pipeline):
    """Items queued together go out as one batch; every batch is padded to
    batch_size with 1-frame silences; batch k draws fold_seed(seed, k),
    with the 2-deep pipelined worker and the sequential one."""
    svc = _service(batch_size=4, batch_window_ms=1000.0, seed=7, pipeline_dispatch=pipeline)
    calls = []
    real = svc.enhancer.dispatch

    def spy(wavs, ys=None, seed=None, **kw):
        calls.append(([len(w) for w in wavs], seed))
        return real(wavs, ys, seed, **kw)

    svc.enhancer.dispatch = spy
    try:
        _park(svc)
        xs = [_noisy(0.3 + 0.05 * i, seed=i) for i in range(3)]
        items = [svc._admit(x, "self-soft", True) for x in xs]
        _unpark(svc)
        outs = [svc._await(it, TIMEOUT) for it in items]
        assert all(_partition_ok(s, n, x) for (s, n), x in zip(outs, xs))
        s, n = svc.submit(xs[0], timeout=TIMEOUT)
        nfft = svc.enh_cfg.stft.nfft
        assert calls == [([len(x) for x in xs] + [nfft], fold_seed(7, 0)),
                         ([len(xs[0])] + [nfft] * 3, fold_seed(7, 1))]
        _settle(svc)
        st = svc.stats_snapshot()
        assert st["batches"] == 2 and st["utterances"] == 4
    finally:
        svc.close()


def test_self_soft_labels_run_on_the_worker(monkeypatch):
    """v5 labels its requests with its own classifier, in one batched call
    per batch on the worker thread; ones/zeros are the constant labels; m2
    has no classifier."""
    seen = []
    real = tservice.self_soft_labels

    def spy(model, wavs, *a, **kw):
        seen.append((threading.current_thread().name, len(wavs)))
        return real(model, wavs, *a, **kw)

    monkeypatch.setattr(tservice, "self_soft_labels", spy)
    svc = _service(_tmodel(0, DisentangledVAE, 1), "v5",
                   EnhancerConfig(mcem=McemConfig(**QUICK), y_mode="dec_only"))
    try:
        x = _noisy(0.4)
        for src in ("self-soft", "ones", "zeros"):
            assert _partition_ok(*svc.submit(x, src, timeout=TIMEOUT), x)
        assert seen == [("enhance-worker", 1)]
    finally:
        svc.close()
    with pytest.raises(ValueError, match="no classifier"):
        _service(_tmodel(0, CVAE, 1), "m2", EnhancerConfig(mcem=McemConfig(**QUICK),
                                                           y_mode="enc_dec"))
    m2 = _service(_tmodel(0, CVAE, 1), "m2", EnhancerConfig(mcem=McemConfig(**QUICK),
                                                            y_mode="enc_dec"), y_source="ones")
    try:
        with pytest.raises(ValueError, match="no classifier"):
            m2.submit(_noisy(0.3), "self-soft")
        assert _partition_ok(*m2.submit(_noisy(0.3), timeout=TIMEOUT), _noisy(0.3))
    finally:
        m2.close()


def test_hot_reload(tmp_path):
    new = _tmodel(5)
    torch.save(new.state_dict(), tmp_path / "new.pt")
    torch.save(VAE(513, 5, (16, 16)).state_dict(), tmp_path / "wrong.pt")
    svc = _service()
    with serving(svc) as url:
        x = _noisy(0.3)
        assert np.isfinite(svc.submit(x, timeout=TIMEOUT)[0]).all()
        svc.reload_checkpoint(tmp_path / "new.pt")
        assert svc.stats_snapshot()["reloads"] == 1 and svc.checkpoint.endswith("new.pt")
        for k, v in new.state_dict().items():
            torch.testing.assert_close(svc.enhancer.model.state_dict()[k], v)
        with pytest.raises(ValueError, match="does not fit"):
            svc.reload_checkpoint(tmp_path / "wrong.pt")
        for k, v in new.state_dict().items():  # untouched by the failed reload
            torch.testing.assert_close(svc.enhancer.model.state_dict()[k], v)
        assert _partition_ok(*svc.submit(x, timeout=TIMEOUT), x)
        status, _, body = _post(f"{url}/reload?checkpoint={tmp_path / 'new.pt'}", b"")
        assert status == 200 and json.loads(body)["status"] == "reloaded"
        assert _get_json(f"{url}/healthz")["checkpoint"] == str(tmp_path / "new.pt")
        assert _raw(url, "POST", f"/reload?checkpoint={tmp_path / 'wrong.pt'}")[0] == 400
        assert svc.stats_snapshot()["reloads"] == 2


def test_warmup_async_readiness_and_failure():
    svc = _service()
    with serving(svc) as url:
        assert svc.ready.is_set()  # no warmup requested: born ready
        done = []
        svc.warmup_async([64], on_done=done.append)
        status, _, body = _post(f"{url}/enhance", _wav_body(_noisy()))  # races the warmup
        assert status == 200 and len(body) > 44
        assert svc.ready.wait(TIMEOUT) and done == [None]
        assert svc.warm_buckets == [64] and svc.warmup_error is None
        _settle(svc)
        st = svc.stats_snapshot()  # warmup batches stay out of the serving counters
        assert st["requests"] == st["utterances"] == 1 and st["warmup_seconds"] > 0
        svc.ready.clear()
        assert _get_json(f"{url}/healthz")["status"] == "warming"

        done2 = []
        svc.warmup_async([-64], on_done=done2.append)  # an impossible bucket
        deadline = time.monotonic() + TIMEOUT
        while not done2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(done2) == 1 and done2[0] is not None and svc.warmup_error is done2[0]
        h = _get_json(f"{url}/healthz")
        assert not svc.ready.is_set() and h["status"] == "warmup failed" and "warmup_error" in h


def test_warmup_batch_failure_fails_the_warmup():
    """A device batch that raises during warmup (e.g. a kernel that does not
    build) fails the warmup instead of being served some other way."""
    svc = _service()
    try:
        def broken(*a, **kw):
            raise RuntimeError("nvcc failed for mh_chain.cu")

        svc.enhancer.dispatch = broken
        done = []
        svc.warmup_async([64], on_done=done.append)
        deadline = time.monotonic() + TIMEOUT
        while not done and time.monotonic() < deadline:
            time.sleep(0.01)
        assert isinstance(done[0], EnhancementError) and "nvcc failed" in str(done[0])
        assert not svc.ready.is_set() and svc.warm_buckets == []
    finally:
        svc.close()


def test_bounded_queue_abandoned_items_and_close():
    svc = _service(max_queue=2)
    try:
        _park(svc)
        ghost = svc._admit(_noisy(0.3, seed=5), "self-soft", True)
        ghost.abandoned = True                    # its waiter gave up
        queued = svc._admit(_noisy(0.3, seed=1), "self-soft", True)
        with pytest.raises(ServiceOverloaded, match="queue full"):
            svc.submit(_noisy(0.3, seed=99))
        assert svc.stats["rejected"] == 1
        _unpark(svc)
        assert _partition_ok(*svc._await(queued, TIMEOUT), _noisy(0.3, seed=1))
        assert not ghost.done.is_set()  # dropped, never served
        _settle(svc)
        assert svc.stats_snapshot()["utterances"] == 1
        _park(svc)
        left = svc._admit(_noisy(0.3), "self-soft", True)
    finally:
        svc.close()
    assert left.done.is_set() and isinstance(left.error, EnhancementError)


def test_worker_survives_bad_batches_and_counts_timeouts():
    svc = _service(latency_window=0)
    try:
        with pytest.raises(ValueError, match="empty"):
            svc.submit(np.zeros(0, np.float32))
        orig_d, orig_c = svc.enhancer.dispatch, svc.enhancer.collect
        svc.enhancer.dispatch = lambda *a, **k: (_ for _ in ()).throw(ValueError("misconfig"))
        with pytest.raises(EnhancementError, match="misconfig"):
            svc.submit(_noisy(0.3), timeout=TIMEOUT)
        svc.enhancer.dispatch = orig_d
        svc.enhancer.collect = lambda h: (_ for _ in ()).throw(ValueError("fault at fetch"))
        with pytest.raises(EnhancementError, match="fault at fetch"):
            svc.submit(_noisy(0.3), timeout=TIMEOUT)
        svc.enhancer.collect = orig_c
        assert _partition_ok(*svc.submit(_noisy(0.3), timeout=TIMEOUT), _noisy(0.3))
        assert len(svc._latencies) == 1  # latency_window=0 clamps to 1
        st = svc.stats_snapshot()
        assert st["failed"] == 2 and st["requests"] == 1
        _park(svc)
        with pytest.raises(TimeoutError):
            svc.submit(_noisy(0.3, seed=1), timeout=0.1)
        assert svc.stats_snapshot()["timeouts"] == 1
    finally:
        svc.close()


def test_drain_answers_inflight_then_rejects():
    svc = _service(batch_window_ms=1000.0, batch_size=4)
    try:
        _park(svc)
        item = svc._admit(_noisy(0.3), "self-soft", True)
        _unpark(svc)
        assert svc.drain(timeout=TIMEOUT)
        assert item.done.is_set() and item.error is None
        with pytest.raises(ServiceOverloaded, match="draining"):
            svc.submit(_noisy(0.3, seed=1))
        assert not svc._worker.is_alive()
    finally:
        svc.close()


def test_chunked_request_counts_once_and_drain_lets_it_finish():
    svc = _service(chunk_seconds=1.0, max_queue=3)
    try:
        x = _noisy(4.0)
        n_chunks = len(chunk_spans(len(x), 16000, 256, 1.0, 0.25))
        results = {}
        t = threading.Thread(target=lambda: results.update(out=svc.submit(x, timeout=TIMEOUT)))
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline and not svc._chunked_inflight and "out" not in results:
            time.sleep(0.002)
        assert svc.drain(timeout=TIMEOUT)   # waits the started request out
        t.join(timeout=TIMEOUT)
        assert not t.is_alive() and _partition_ok(*results["out"], x)
        st = svc.stats_snapshot()
        assert st["requests"] == 1 and st["utterances"] == n_chunks > 3  # > max_queue
        assert st["rejected"] == 0
        with pytest.raises(ServiceOverloaded, match="draining"):
            svc.submit(_noisy(2.0, seed=1))
    finally:
        svc.close()


def test_submit_stream_covers_request_and_close_abandons_tail():
    svc = _service(chunk_seconds=1.0, batch_size=1)
    try:
        x = _noisy(5.0)
        segs = list(svc.submit_stream(x, timeout=TIMEOUT))
        assert len(segs) > 1
        s = np.concatenate([a for a, _ in segs])
        n = np.concatenate([b for _, b in segs])
        assert _partition_ok(s, n, x)
        assert svc.stats_snapshot()["requests"] == 1
        assert len(list(svc.submit_stream(_noisy(0.5), timeout=TIMEOUT))) == 1
        with pytest.raises(ValueError, match="cap"):
            svc.submit_stream(np.zeros(16000 * 31, np.float32))

        gen = svc.submit_stream(x, timeout=TIMEOUT)
        next(gen)
        gen.close()                      # the consumer went away
        assert svc._chunked_inflight == 0
        deadline = time.monotonic() + TIMEOUT
        while svc._unfinished and time.monotonic() < deadline:
            time.sleep(0.01)
        st = svc.stats_snapshot()
        assert svc._unfinished == 0 and st["requests"] == 2  # the abandoned one uncounted
        assert _partition_ok(*svc.submit(_noisy(0.4), timeout=TIMEOUT), _noisy(0.4))
    finally:
        svc.close()


@pytest.mark.parametrize("path", ["duplex", "buffered"])
def test_http_stream_exact_length_and_partition(path):
    """?stream=1: a model-rate PCM body takes the full-duplex path, another
    rate (resampled) the buffered one; both answer an exact-length wav."""
    svc = _service(chunk_seconds=1.0)
    with serving(svc) as url:
        fs_in = 16000 if path == "duplex" else 8000
        x_in = _noisy(3.3, fs_in)
        status, headers, body = _post(
            f"{url}/enhance?stream=1&return=stereo&resample=1", _wav_body(x_in, fs_in))
        fs, data = wavfile.read(io.BytesIO(body))
        x = x_in if path == "duplex" else tserving._parse_wav_bytes(_wav_body(x_in, 8000))[0]
        assert status == 200 and fs == 16000 and int(headers["Content-Length"]) == len(body)
        if path == "duplex":
            assert data.shape == (len(x), 2)
            assert _partition_ok(data[:, 0] / 32768.0, data[:, 1] / 32768.0, x)
        else:
            assert abs(len(data) - 2 * len(x_in)) <= 2
        # the handler counts the request once its generator ends, which may
        # come after the client has read the last byte
        deadline = time.monotonic() + TIMEOUT
        while svc.stats_snapshot()["requests"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        st = svc.stats_snapshot()
        assert st["requests"] == 1 and st["utterances"] > 1


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnhanceService(_tmodel(), "m1", cfg=ServeConfig(warmup_buckets=()))


def test_boot_imports_only_the_stdlib():
    path = REPO / "dvae_tpu_torch" / "serving" / "boot.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module.startswith("dvae_tpu_torch.serving.http"):
                continue  # attach_service's lazy import, after the bind
            roots.add(node.module.split(".")[0])
    assert roots and roots <= set(sys.stdlib_module_names), roots - set(sys.stdlib_module_names)
    # loaded as a standalone file where torch and numpy cannot be imported
    probe = (
        "import importlib.util, sys\n"
        "sys.modules['torch'] = sys.modules['numpy'] = None\n"
        f"spec = importlib.util.spec_from_file_location('boot', {str(path)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "t = m.BootTimer()\n"
        "with t.phase('imports'): pass\n"
        "print(sorted(t.snapshot()['phases']))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['imports']"
    assert importlib.util.find_spec("dvae_tpu_torch.serving.boot") is not None


def test_boot_server_answers_until_attach():
    from dvae_tpu_torch.serving.boot import BootTimer, attach_service, bind_boot_server

    boot = BootTimer()
    srv = bind_boot_server("127.0.0.1", 0, boot)
    svc = None
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        h = _get_json(f"{url}/healthz")
        assert h["status"] == "booting" and "port_bound" in h["boot"]["marks"]
        assert _raw(url, "POST", "/enhance", _wav_body(_noisy(0.3)))[:2] == (503, True)
        svc = _service()
        svc.boot = boot
        attach_service(srv, svc)
        h = _get_json(f"{url}/healthz")
        assert h["status"] == "ok" and "boot" in h
    finally:
        srv.shutdown()
        srv.server_close()
        srv._serve_thread.join(timeout=10)
        if svc is not None:
            svc.close()


def test_servers_listen_with_a_backlog_for_bursts():
    """Both server constructions listen with a backlog of 128: with
    socketserver's default of 5, the connection requests of a burst of
    concurrent clients beyond it are dropped and the kernel retries them
    only after 1 s, past any micro-batch window. A burst of 32 concurrent
    connections is answered."""
    from dvae_tpu_torch.serving.boot import BootTimer, bind_boot_server

    boot_srv = bind_boot_server("127.0.0.1", 0, BootTimer())
    try:
        assert boot_srv.request_queue_size == 128 and not boot_srv.daemon_threads
    finally:
        boot_srv.shutdown()
        boot_srv.server_close()
    svc = _service()
    with serving(svc) as url:
        codes, errors = [], []

        def hit():
            try:
                with urllib.request.urlopen(f"{url}/healthz", timeout=TIMEOUT) as r:
                    codes.append(r.status)
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=hit) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not errors and codes == [200] * 32
    srv = tserving.make_server(_service(), "127.0.0.1", 0)
    try:
        assert srv.request_queue_size == 128 and not srv.daemon_threads
    finally:
        srv.server_close()
        srv.RequestHandlerClass.service.close()

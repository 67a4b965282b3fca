"""The port's ``python -m dvae_tpu_torch.cli.serve`` on the CPU.

A subprocess with ``--platform cpu`` on a tiny ``.pt`` model: /healthz goes
ready, one request is answered with the Wiener partition, and SIGTERM
drains and exits 0, all under deadlines (the process is killed in
``finally`` whatever happens). Without ``--platform`` the server refuses to
start on a machine with no card, and frees its port. Argument errors, and
the chunk bucket that ``--chunk-seconds`` adds to the warmup.
"""

import io
import json
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from dvae_tpu_torch.cli import serve
from dvae_tpu_torch.models import VAE
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

TINY = ["--z-dim", "4", "--h-dim", "16", "16", "--niter", "2", "--nsamples-e-step", "1",
        "--burnin-e-step", "1", "--nsamples-wf", "1", "--burnin-wf", "1"]
DEADLINE = 90


@pytest.fixture
def ckpt(tmp_path):
    torch.manual_seed(0)
    path = tmp_path / "m1.pt"
    torch.save(VAE(513, 4, (16, 16)).state_dict(), path)
    return path


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_boots_answers_and_drains(ckpt):
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dvae_tpu_torch.cli.serve", "--checkpoint", str(ckpt), *TINY,
         "--platform", "cpu", "--port", str(port), "--warmup-buckets", "64", "--batch-size",
         "2"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + DEADLINE
        health = {}
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                if health.get("ready"):
                    break
            except OSError:
                pass
            time.sleep(0.1)
        assert health.get("ready"), (health, proc.poll())
        assert health["platform"] == "cpu" and health["warm_buckets"] == [64]
        assert {"imports", "backend_init", "model_load", "service_init", "warmup"} <= set(
            health["boot"]["phases"])
        rng = np.random.default_rng(0)
        x = (0.3 * np.sin(np.arange(12000) * 0.1) + 0.05 * rng.standard_normal(12000))
        buf = io.BytesIO()
        wavfile.write(buf, 16000, np.rint(x * 32768).astype(np.int16))
        req = urllib.request.Request(f"{url}/enhance?return=stereo", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=DEADLINE) as r:
            assert r.status == 200
            data = wavfile.read(io.BytesIO(r.read()))[1] / 32768.0
        assert data.shape == (len(x), 2)
        assert np.median(np.abs(data.sum(-1) - x)[:-1024]) < 5e-3
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=DEADLINE)
        assert proc.returncode == 0, err
        assert "SIGTERM: draining" in out and "drained, stopping" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)


def test_serve_cli_without_platform_needs_a_card(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port = _free_port()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--checkpoint", str(ckpt), *TINY, "--port", str(port)])
    with socket.socket() as s:  # the boot server let its port go
        s.bind(("127.0.0.1", port))


@pytest.mark.parametrize("args,message", [
    # the parser takes --data-parallel; the service under a mesh:
    # tests/test_torch_port_parallel.py
    (["--data-parallel", "--platform", "tpu"], "invalid choice: 'tpu'"),
    (["--model-class", "m2"], "m2 has no classifier"),
    (["--std-norm"], "--std-norm requires --norm-h5"),
    (["--platform", "tpu"], "invalid choice: 'tpu'"),
    (["--aot-cache", "x"], "unrecognized arguments: --aot-cache"),
])
def test_serve_cli_argument_errors(ckpt, capsys, args, message):
    with pytest.raises(SystemExit) as e:
        serve.main(["--checkpoint", str(ckpt), *args])
    assert e.value.code == 2 and message in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main([])
    assert "need --checkpoint or --model-dir" in capsys.readouterr().err


def test_chunk_seconds_adds_the_chunk_bucket(ckpt):
    def buckets(*extra):
        return serve.warmup_buckets(serve.parse_args(["--checkpoint", str(ckpt), *extra]))

    assert buckets() == [64, 256]
    assert buckets("--chunk-seconds", "4") == [64, 256]     # 250 frames -> 256
    assert buckets("--chunk-seconds", "5") == [64, 256, 320]
    assert buckets("--chunk-seconds", "5", "--warmup-buckets") == []

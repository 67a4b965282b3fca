"""The benchmark's audio-visual configuration (``benchmark/configs/
m2info_av.json`` and its plain reference ``m2info_av.py``) run whole on
the CPU at a trial size through ``benchmark.harness.run``: served through
the port's own ``EnhanceService`` with its label network, and offline
through ``enhance/labeling.py::video_vad_labels``. Both come out
``correct``, and three planted faults of the labels (one frame late, the
network's head weight x 1.01, the next mixture's video) each fail
``labels_gap`` at the cell's limit."""

import json
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness, spec  # noqa: E402
from dvae_tpu_torch.serving import service  # noqa: E402

CELL = "m2info_av.serve.open"
PROGRAM = "dvae_tpu_torch.enhance.labeling:video_vad_labels"
SEED = 2**31 + 23


def trial(traffic: str) -> spec.Cell:
    """The committed cell cut to a size a test holds: 3 EM iterations, 6
    mixtures of 1-1.6 s (batches of 3 offline, 4 requests/s served), a
    32-wide prior and a small video network; its limits as committed."""
    cell = spec.load_cell(CELL)
    cfg = cell.config
    assert cfg["label_net"]["program"] == PROGRAM and cfg["inputs"] == ["video"]
    cfg["mcem"]["niter"] = 3
    cfg["model"]["h_dim"] = [32, 32]
    cfg["label_net"].update(hidden=24, emb_dim=16, conv_features=[4, 8, 8])
    if traffic != cell.traffic["mode"]:
        cell.traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{traffic}.json")
                                  .read_text())
        cell.end_to_end = [{"name": "offline_audio_s_per_s", "unit": "s/s"},
                           {"name": "setup_s", "unit": "s"}]
    cell.traffic.update(pool=6, min_s=1.0, max_s=1.6, batch=3)
    if cell.traffic["mode"] == "open_loop":
        cell.traffic["rate_per_s"] = 4.0
    cell.check["dispatch"] = [0, 1]
    cell.per_layer = []
    return cell


def cpu_run(cell):
    return harness.run(cell, SEED, 0.5, False, torch.device("cpu"), time.monotonic())


def over(out) -> set:
    return {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("traffic", ["offline", "open_loop"])
def test_the_audio_visual_configuration_runs_correct(traffic, monkeypatch):
    calls = []
    real = service.video_vad_labels

    def counted(*a, **k):
        calls.append(len(a[1]))
        return real(*a, **k)

    monkeypatch.setattr(service, "video_vad_labels", counted)
    out = cpu_run(trial(traffic))
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["failed"] == 0 and out["result"]["attempted"] > 0
    assert out["checks"]["labels_gap"]["value"] < 2e-7
    assert "b2_power_rel" not in out["checks"]
    # served, the service's own worker labelled every batch
    assert bool(calls) == (traffic == "open_loop")


def _shifted(fn):
    """Labels one frame late."""
    return lambda *a, **k: [np.concatenate([y[:1], y[:-1]]) for y in fn(*a, **k)]


def _weight_scaled(fn):
    """The network's head weight x 1.01."""
    def call(net, *a, **k):
        if not getattr(net, "_planted", False):
            with torch.no_grad():
                net.head.weight.mul_(1.01)
            net._planted = True
        return fn(net, *a, **k)
    return call


def _wrong_video(fn):
    """Each mixture labelled from the next one's video (its own reversed
    when alone), cycled or cut to its own clip's frames."""
    def call(net, wavs, side, *a, **k):
        clips = side["video"]
        wrong = [clips[(i + 1) % len(clips)] if len(clips) > 1 else clips[i][::-1]
                 for i in range(len(clips))]
        return fn(net, wavs, {"video": [w[np.arange(len(c)) % len(w)]
                                        for w, c in zip(wrong, clips)]}, *a, **k)
    return call


@pytest.mark.parametrize("traffic", ["offline", "open_loop"])
@pytest.mark.parametrize("fault", [_shifted, _weight_scaled, _wrong_video],
                         ids=["shifted-one-frame", "weight-x1.01", "wrong-video"])
def test_a_label_fault_fails_labels_gap(monkeypatch, fault, traffic):
    real = harness.resolve
    planted = fault(real(PROGRAM))
    monkeypatch.setattr(harness, "resolve", lambda name: planted if name == PROGRAM
                        else real(name))
    monkeypatch.setattr(service, "video_vad_labels", fault(service.video_vad_labels))
    out = cpu_run(trial(traffic))
    assert not out["result"]["correct"]
    assert "labels_gap" in over(out), out["checks"]


def test_the_configuration_keeps_m2info_s_keys():
    """``m2info_av`` is ``m2info`` with a label network, its input and its
    labels: every other key as ``m2info.json`` has it."""
    here = ROOT / "benchmark" / "configs"
    av, base = (json.loads((here / f"{n}.json").read_text()) for n in ("m2info_av", "m2info"))
    new = {"label_net", "inputs", "labels", "name", "source", "assumed"}
    assert {k: v for k, v in av.items() if k not in new} == {
        k: v for k, v in base.items() if k not in new}
    assert av["labels"] == {"source": "net", "y_dim": 1} and av["reduced"] == []
    ref = spec.load_cell(CELL).reference
    assert ref.net_labels.__module__ == "benchmark.reference.vad"
    assert ref.label_flops(av, 10) == 10 * ref.label_flops(av, 1) > 0
    assert av["label_net"]["class"] == "VideoVad"

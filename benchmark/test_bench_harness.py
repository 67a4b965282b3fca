"""Tests of the benchmark harness, run from the repository's root:

    python -m pytest benchmark/test_bench_harness.py -q

The CPU tests drive whole runs at a small size (the program's CPU path:
the plain chain and the plain STFT power in place of the two kernels);
the test marked ``cuda`` runs one cell on the card and skips here.
"""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import check, faults, harness, spec, work  # noqa: E402
from benchmark.reference.precision import round_bits  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
HERE = ROOT / "benchmark"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def small(name: str) -> spec.Cell:
    """The cell ``name`` cut to a size a test run holds: 3 EM iterations,
    a pool of 6 short mixtures in batches of 3, few requests."""
    cell = spec.load_cell(name)
    cell.config["mcem"]["niter"] = 3
    cell.traffic.update(pool=6, min_s=1.0, max_s=1.6, batch=3)
    if cell.traffic["mode"] == "open_loop":
        cell.traffic["rate_per_s"] = 4.0
    cell.check["dispatch"] = [0, 1]
    return cell


def cpu_run(cell, seconds=0.5, traced=False, seed=2**31 + 7):
    return harness.run(cell, seed, seconds, traced, torch.device("cpu"), time.monotonic())


# -- the files the harness finds by name --------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_workload_files_name_existing_files(name):
    cell = spec.load_cell(name)
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert (HERE / "configs" / f"{entry['config']}.json").is_file()
    assert (HERE / "configs" / f"{entry['config']}.py").is_file()
    assert (HERE / "traffic" / f"{entry['traffic']}.json").is_file()
    assert cell.traffic["mode"] in ("batches", "open_loop")
    assert cell.limits and all(isinstance(v, float) for v in cell.limits.values())
    if cell.traffic["mode"] == "open_loop":
        assert cell.traffic["rate_per_s"] > 0
    for m in cell.per_layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_every_reader_is_a_metric_and_every_config_is_used():
    names = {m["name"] for m in BENCH["per_layer"]}
    assert {p.name[:-3] for p in (HERE / "metrics").glob("*.py")} == names
    used = {w["config"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == used
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


# -- the yardstick ----------------------------------------------------------------------------


def test_work_counts_match_hand_worked_values():
    assert work.chain_work(2, 3, 2, (4,), 1, 1, False) == (240, 108, 54, 268)
    assert work.m_step_work(2, 1, 3, 4, 2) == (552, 144)
    assert work.stft_power_work(2, 100, 8, 5, False) == (286.0, 440)
    mc = dict(niter=1, burnin_e_step=1, nsamples_e_step=1, burnin_wf=1, nsamples_wf=1)
    assert work.enhance_flops(1, mc, 3, 2, (4,), 8) == 605.0
    ms, what = work.bound_ms(67e12, 0)
    assert (ms, what) == (1000.0, "operations")


def test_round_bits_is_the_bf16_cast_at_seven_bits():
    x = torch.randn(10000) * torch.logspace(-20, 20, 10000)
    assert torch.equal(round_bits(x, 7), x.to(torch.bfloat16).float())
    assert torch.equal(round_bits(x, None), x)
    assert float((round_bits(x, 3) - x).abs().div(x.abs()).max()) <= 2.0 ** -4


# -- whole runs on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["m1.offline.sorted", "m2info.serve.open"])
def test_reference_agrees_with_the_port_cpu_path(name):
    out = cpu_run(small(name))
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["failed"] == 0 and out["result"]["attempted"] > 0


def test_result_line_has_the_required_keys():
    from benchmark import run as run_py

    cell = small("m2info.offline.sorted")
    out = cpu_run(cell, traced=True)
    notes = out["notes"]
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": notes.pop("memory_peak_bytes"),
              "busy_s": notes.pop("busy_s"), "window_s": notes.pop("window_s")}
    notes.pop("forbidden_after_window")
    line = json.loads(json.dumps(run_py.line(out, device)))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    units = {m["name"]: m["unit"] for m in BENCH["per_layer"]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and np.isfinite(m["value"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "m1.offline.sorted", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""


# -- the control and the faults fail ------------------------------------------------------


@pytest.mark.parametrize("name", ["m1.offline.sorted", "m2info.serve.open"])
def test_the_control_fails_the_limits(monkeypatch, name):
    """The reference one precision step lower, in the program's place."""
    orig = check.numbers
    monkeypatch.setattr(check, "numbers",
                        lambda rec, outputs, w, cfg, ref: orig(rec, outputs, w, cfg, ref, True))
    out = cpu_run(small(name))
    assert not out["result"]["correct"]
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert {"power_rel", "encoder_rel", "estep_mismatch_pct", "mstep_rel", "tail_quanta"} <= over
    if name.startswith("m2info"):
        # the labels' own gap is read on the card at the cell's size (its
        # short mixtures here leave most labels saturated at 0 or 1)
        assert "b2_power_rel" in over


def _fault_mstep_unchanged(mcem, pipeline):
    from dvae_tpu_torch.enhance.nmf import compute_vb

    return mcem, "nmf_m_step", lambda orig: (
        lambda x2, vs, w, h, g, mask, eps=1e-8: (w, h, g, compute_vb(w, h)))


def _fault_chain_unchanged(mcem, pipeline):
    def wrap(orig):
        def chain(mats, x2, vb, g, z, y, noise, n_burn, n_samples, var_rw, wf_mode=False,
                  fast_decoder=False, fast_stats=False):
            return orig(mats, x2, vb, g, z, y, noise, n_burn, n_samples, 0.0, wf_mode,
                        fast_decoder, fast_stats)
        return chain
    return mcem, "run_mh_chain", wrap


def _fault_half_batch(mcem, pipeline):
    def wrap(orig):
        def m_step(x2, vs, w, h, g, mask, eps=1e-8):
            half = max(1, x2.shape[0] // 2)
            out = orig(x2[:half], vs[:, :half], w[:half], h[:half], g[:half], mask[:half], eps)
            return tuple(torch.cat([t] * (-(-x2.shape[0] // half)))[:x2.shape[0]] for t in out)
        return m_step
    return mcem, "nmf_m_step", wrap


def _fault_answer_altered(mcem, pipeline):
    def wrap(orig):
        def collect(self, handle):
            out = orig(self, handle)
            s, n = out[0]
            out[0] = (s * 1.01, n)
            return out
        return collect
    return pipeline.Enhancer, "_collect", wrap


@pytest.mark.parametrize("fault", [_fault_mstep_unchanged, _fault_chain_unchanged,
                                   _fault_half_batch, _fault_answer_altered],
                         ids=["mstep-unchanged", "chain-unchanged", "half-batch",
                              "answer-altered"])
@pytest.mark.parametrize("name", ["m1.offline.sorted", "m1.serve.open"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, name):
    from dvae_tpu_torch.enhance import mcem, pipeline

    owner, attr, wrap = fault(mcem, pipeline)
    monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    out = cpu_run(small(name))
    assert not out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.ENGINE_FAULTS))
@pytest.mark.parametrize("name", ["m1.offline.sorted", "m2info.serve.open"])
def test_a_broken_hand_over_is_not_correct(fault, name):
    """Every stage right on its own inputs, the state between them broken:
    only ``links_bad`` reads it."""
    with faults.planted(fault):
        out = cpu_run(small(name))
    assert not out["result"]["correct"]
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert "links_bad" in over, out["checks"]


def test_noise_off_its_law_is_caught(monkeypatch):
    """Chain noise drawn off its law, which the reference replays: only
    ``noise_z`` can read it (faults larger than the cell's, at this size)."""
    from dvae_tpu_torch.enhance import mcem

    orig = mcem.make_chain_noise
    for scale in ((1.2, 1.0), (1.0, 1.5)):
        def noise(n_steps, rows, l, generator, device, scale=scale):
            t = orig(n_steps, rows, l, generator, device)
            return torch.cat([t[..., :l] * scale[0], t[..., l:] * scale[1]], -1)
        monkeypatch.setattr(mcem, "make_chain_noise", noise)
        out = cpu_run(small("m1.offline.sorted"))
        assert not out["result"]["correct"]
        assert out["checks"]["noise_z"]["value"] > out["checks"]["noise_z"]["limit"]


def test_noise_z_reads_the_planted_faults_at_the_cells_size():
    """At the smallest served batch (8 requests of one 64-frame bucket):
    three E-step segments and the Wiener segment's noise."""
    gen = torch.Generator().manual_seed(3)

    def seg(steps):
        eps = torch.randn((steps, 512, 16), generator=gen)
        logu = torch.rand((steps, 512, 1), generator=gen).clamp_min(1e-38).log()
        return {"noise": torch.cat([eps, logu], -1)}

    rec = {"estep": {i: seg(40) for i in range(3)}, "wf": seg(100)}
    limit = json.loads((HERE / "workloads" / "m1.serve.open.json").read_text())["limits"]
    assert check.noise_z(rec, 16) < limit["noise_z"]
    for fault in check.NOISE_FAULTS:
        assert check.noise_z(rec, 16, fault) > limit["noise_z"]


# -- what the measured process may import --------------------------------------------------


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
        if not path.name.startswith("test_"):
            text = path.read_text()
            assert "bench.py" not in text and "BENCH_" not in text, path


def test_the_reference_imports_nothing_of_the_program():
    for path in [*(HERE / "reference").glob("*.py"), *(HERE / "configs").glob("*.py")]:
        assert "dvae_tpu_torch" not in _imports(path), path


def test_a_run_holds_no_forbidden_module():
    cpu_run(small("m1.offline.sorted"))
    assert harness.forbidden_modules() == []


# -- on the card ------------------------------------------------------------------------------


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "m1.offline.sorted", "--seed", "2147483659", "--seconds", "5",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert done.returncode == 0, done.stderr[-2000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]

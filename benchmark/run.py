"""Measure one cell of ``BENCHMARK.json`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers the check compares, each beside its limit, as the last
lines of standard error, and one JSON result line as the last line of
standard output. Exits non-zero, with no result, when there is no card (or
fewer than the cell asks for), when the program is missing, or when the
process holds ``jax``, ``jaxlib``, ``flax`` or ``dvae_tpu`` once the window
has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels under ``build/`` itself)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _finite(x):
    """``x`` with every non-finite float replaced by None (JSON has none)."""
    if isinstance(x, float):
        return x if x == x and abs(x) != float("inf") else None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def line(out: dict, device: dict) -> dict:
    """The result line: its required keys, then the run's notes, then
    the numbers compared with their limits, last."""
    result = dict(out["result"])
    result["device"] = device
    result["notes"] = out["notes"]
    result["checks"] = out["checks"]
    return _finite(result)


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, spec

    try:
        cell = spec.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        return _fail(f"no cell {args.workload!r} ({e})", 2)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return _fail(f"needs {cell.chips} CUDA device(s); found "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    try:
        import dvae_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program (dvae_tpu_torch) is not in this checkout: {e}", 4)
    torch.cuda.reset_peak_memory_stats()
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                      T_START, sync=torch.cuda.synchronize,
                      memory_peak=torch.cuda.max_memory_allocated)
    notes = out["notes"]
    bad = sorted(set(notes.pop("forbidden_after_window")) | set(harness.forbidden_modules()))
    if bad:
        return _fail(f"the measured process holds forbidden modules: {bad}", 5)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(notes.pop("memory_peak_bytes")),
              "power_limit": harness.power_limit()}
    if args.trace:
        device["busy_s"], device["window_s"] = notes.pop("busy_s"), notes.pop("window_s")
    result = line(out, device)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

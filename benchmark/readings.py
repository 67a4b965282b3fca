"""Readings for the limits and the rates, on the card, many seeds in one
process (not part of a benchmark run).

    python3 benchmark/readings.py --cell <cell> --seeds 1,2,3 --seconds 4 [--control]
        [--faults] [--rates 8,12]

For each seed (and each rate of an open-loop cell) it runs the cell as
``run.py`` would and prints one JSON line: the program's numbers, the
control's on the same recorded dispatch with ``--control`` (the reference
one precision step lower put in the program's place, and ``noise_z`` of
the recorded noise with each of ``check.NOISE_FAULTS`` planted), the
end-to-end metrics and, for an open loop, what shows a growing backlog:
refusals and the median latency of the first and last thirds of the
requests. ``--faults`` runs each seed once more under each of
``faults.ENGINE_FAULTS``.
"""

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--rates", default="")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark import check, drive, faults, harness, spec

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.cell)
    control = {}
    orig = check.numbers

    def numbers(rec, outputs, w, cfg, ref, control_=False, **kw):
        if args.control and not control.get("plant"):
            control["nums"] = orig(rec, outputs, w, cfg, ref, True, **kw)
            control["nums"].update({f"noise_z.{f}": check.noise_z(rec, cfg["model"]["z_dim"], f)
                                    for f in check.NOISE_FAULTS})
        return orig(rec, outputs, w, cfg, ref, **kw)

    check.numbers = numbers
    lat = {}
    orig_run = drive.OpenLoop.run

    def open_run(self, seconds):
        res = orig_run(self, seconds)
        v = np.asarray(res["latency"])
        third = max(1, len(v) // 3)
        lat.update(first=float(np.median(v[:third])), last=float(np.median(v[-third:])),
                   unanswered=int((~np.isfinite(v)).sum()))
        return res

    drive.OpenLoop.run = open_run
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    plants = [None] + (sorted(faults.ENGINE_FAULTS) if args.faults else [])
    for seed in (int(s) for s in args.seeds.split(",")):
        for rate in rates:
            for plant in plants:
                if rate is not None:
                    cell.traffic["rate_per_s"] = rate
                torch.cuda.reset_peak_memory_stats()
                control.clear()
                control["plant"] = plant
                t = time.monotonic()
                with faults.planted(plant) if plant else contextlib.nullcontext():
                    out = harness.run(cell, seed, args.seconds, False, torch.device("cuda"), t,
                                      sync=torch.cuda.synchronize,
                                      memory_peak=torch.cuda.max_memory_allocated)
                line = {"cell": args.cell, "seed": seed, "rate": rate, "fault": plant,
                        "program": {k: v["value"] for k, v in out["checks"].items()},
                        "control": control.get("nums") if plant is None else None,
                        "metrics": {k: v["value"] for k, v in out["result"]["metrics"].items()},
                        "attempted": out["result"]["attempted"],
                        "failed": out["result"]["failed"], "notes": out["notes"],
                        "latency_thirds": dict(lat), "wall_s": time.monotonic() - t}
                text = json.dumps(line)
                print(text, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

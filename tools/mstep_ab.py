#!/usr/bin/env python3
"""Time layouts of the fused NMF M-step (``csrc/nmf_mstep.cu``) on one
card, in turns.

    python3 tools/mstep_ab.py [--rounds 5] [--reps 20]
                              [--variant NAME:FIELD=VALUE,...] [...]

A variant is the layout ``nmf.mstep_plan`` picks at a shape with the named
fields of its ``MStepPlan`` replaced (``plan`` replaces none); the fields
that follow from them (tiles, shared memory, scratch, and the pass-2 tile
where only the warps change) are worked out again. Without ``--variant``
the plan is timed alone. At each shape of the benchmark cells and of the
other engines (R, B, N, F, K, the samples' dtype), every variant first
checks its result against the plan's (relative L2 within 1e-4), then each
round times every variant in turn, the order reversed every other round:
CUDA events over ``--reps`` back-to-back calls of ``nmf._launch``. Last, three
calls of each variant under ``torch.profiler`` give its three kernels'
times, and the plain body (``nmf_m_step_reference``) is timed the same way
and its kernels counted. Prints one line per shape and variant (median,
least and most of the rounds, in ms), one for the plain body and, last,
one JSON object with the medians and the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = (  # (R, B, N, F, K, samples), the cells' first
    (10, 32, 320, 513, 10, "bfloat16"),   # the offline cells' longer batches
    (10, 32, 128, 513, 10, "bfloat16"),   # their shorter batches
    (10, 32, 384, 513, 10, "bfloat16"),
    (10, 8, 320, 513, 10, "bfloat16"),    # the served cells
    (30, 32, 320, 513, 10, "bfloat16"),   # m1_reference_effective's budget
    (10, 32, 320, 513, 10, "float32"),    # fast_stats off
    (1, 32, 320, 513, 10, "float32"),     # peem, run_em_fixed_z
)


def variant_plan(base, shape, fields: dict):
    """``base`` (the plan at ``shape``) with ``fields`` replaced and what
    follows from them worked out again."""
    from dvae_tpu_torch.enhance import nmf

    r, b, n, f, k, _ = shape
    vs_bytes = 2 if shape[5] == "bfloat16" else 4
    p = base._replace(**fields)
    p = p._replace(fused=k <= p.kc_t, tiles=math.ceil(n / p.tile1))
    if "stage" in fields and "w_smem2" not in fields:
        p = p._replace(w_smem2=nmf._smem2(r, f, k, vs_bytes, p.warps2, p.stage, p.fused, True)
                       <= nmf._MAX_SMEM)
    if "tile2" not in fields and ({"warps2", "stage", "w_smem2"} & fields.keys()):
        p = p._replace(tile2=nmf._pass2_tile(r, b, n, f, k, vs_bytes, p.stage, p.fused,
                                             p.w_smem2, (p.warps2,))[0])
    return p._replace(smem1=nmf._smem1(k, p.tile1),
                      smem2=nmf._smem2(r, f, k, vs_bytes, p.warps2, p.stage, p.fused, p.w_smem2),
                      scratch=b * p.tiles * 2 * k * f + 2 * b * k * f + b * k)


def parse_variant(text: str) -> tuple:
    name, _, spec = text.partition(":")
    fields = {}
    for item in filter(None, spec.split(",")):
        key, _, value = item.partition("=")
        fields[key] = int(value)
    return name, {k: bool(v) if k in ("stage", "w_smem2") else v
                  for k, v in fields.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dvae_tpu_torch.enhance import nmf

    if not torch.cuda.is_available():
        print("mstep_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, torch.__version__, flush=True)
    variants = [("plan", {})] + [parse_variant(v) for v in args.variant]
    dev = torch.device("cuda")

    def cuda_ms(fn, reps, warm=2):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def rel(a, b):
        a, b = a.double().flatten(1), b.double().flatten(1)
        return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-300)).max())

    medians = {}
    for shape in SHAPES:
        r, b, n, f, k, dts = shape
        gen = torch.Generator(device=dev).manual_seed(0)
        x2 = torch.rand((b, n, f), generator=gen, device=dev) ** 2 * 4 + 1e-3
        vs = (torch.rand((r, b, n, f), generator=gen, device=dev) + 0.05).to(getattr(torch, dts))
        w = torch.rand((b, f, k), generator=gen, device=dev).clamp_min(1e-8)
        h = torch.rand((b, n, k), generator=gen, device=dev).clamp_min(1e-8)
        g = torch.rand((b, n), generator=gen, device=dev) + 0.5
        mask = torch.ones((b, n), device=dev)
        mask[1::3, n - n // 5:] = 0
        data = (x2, vs, w, h, g, mask, 1e-8)
        base = nmf.mstep_plan(r, b, n, f, k, vs.dtype)
        plans = {name: variant_plan(base, shape, fields) for name, fields in variants}
        want = nmf._launch(*data, base)
        for name, plan in plans.items():
            worst = max(rel(a, c) for a, c in zip(nmf._launch(*data, plan), want))
            if not worst <= 1e-4:
                raise SystemExit(f"{name} at {shape}: relative L2 {worst:.3e} against the plan")
        times = {name: [] for name in plans}
        for rnd in range(args.rounds):
            for name in (list(plans) if rnd % 2 == 0 else list(plans)[::-1]):
                times[name].append(cuda_ms(lambda: nmf._launch(*data, plans[name]), args.reps))
        label = "x".join(map(str, shape[:5])) + f" {dts}"
        medians[label] = {}
        for name, plan in plans.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    nmf._launch(*data, plan)
                torch.cuda.synchronize()
            parts = {("p1" if "partial" in e.key else "fin" if "finish" in e.key else "p2"):
                     e.device_time_total / e.count / 1e3 for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA and "mstep" in e.key}
            ms = times[name]
            medians[label][name] = statistics.median(ms)
            print(f"{label} {name}: median {statistics.median(ms):.4f} ms (least {min(ms):.4f}, "
                  f"most {max(ms):.4f}); profiled " +
                  ", ".join(f"{p} {t:.4f}" for p, t in sorted(parts.items())) +
                  f"; tile1 {plan.tile1} kc_t {plan.kc_t} tile2 {plan.tile2} warps2 "
                  f"{plan.warps2} stage {int(plan.stage)} w_smem2 {int(plan.w_smem2)}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            nmf.nmf_m_step_reference(*data)
            torch.cuda.synchronize()
        count = sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        plain = statistics.median(cuda_ms(lambda: nmf.nmf_m_step_reference(*data), 5)
                                  for _ in range(3))
        medians[label]["plain body"] = plain
        print(f"{label} plain body: median {plain:.4f} ms, {count} kernels a call", flush=True)
        del x2, vs, w, h, g, mask, data, want
    print(json.dumps({"card": card, "medians_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

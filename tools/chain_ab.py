#!/usr/bin/env python3
"""Time B1, the MH-chain kernel, from two or more checkouts of the port on
one card, in turns.

    python3 tools/chain_ab.py <root> <root> [...] [--rounds 3] [--h-dim 256 256]
                              [--f32-routes]

Each ``<root>`` is a directory that holds a ``dvae_tpu_torch`` package (a
``git archive`` of another commit, or ``.``). Every round runs each root
in a process of its own, the order reversed every other round (A B B A
...), and each process builds its own kernel and times the bf16 body at
the main path's shapes (F 513, L 16, H 128/128, or the decoder of
``--h-dim`` in the order the CLIs take it): E-step and WF segments (30 +
10 and 75 + 25 steps) at 10,240 rows, a served batch's E-step at 2,560
rows and pmcem's E-step (3 + 1 steps) at 102,400 rows, with f32 planes
and, where the package has ``fast_stats``, with its bf16 planes; CUDA
events over 20 warm calls of the wrapper. With ``--f32-routes`` each
process times the f32 body instead, at a depth of 1 to 8, twice: its
hidden layers read from the kernel's arguments (as the wrapper runs it)
and from the device table the kernel reads at other depths, in turns (A
B B A). Prints one line per process and, last, one JSON object with each
root's median per segment and the card's name and power limit. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

F, L = 513, 16
# (name, rows, WF mode, burn-in, samples)
SEGMENTS = (("E-step", 10240, False, 30, 10), ("WF", 10240, True, 75, 25),
            ("served E-step", 2560, False, 30, 10), ("pmcem E-step", 102400, False, 3, 1))


def _time_root(h_dim: tuple, f32_routes: bool) -> dict:
    """The times of this process's package (already first on sys.path) at
    the decoder of ``VAE(F, L, h_dim)``."""
    import torch

    from dvae_tpu_torch.enhance import mh_chain
    from dvae_tpu_torch.enhance.mh_chain import (
        extract_decoder_mlp,
        make_chain_noise,
        run_mh_chain,
    )
    from dvae_tpu_torch.models import VAE
    from dvae_tpu_torch.models.blocks import init_xavier_

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_xavier_(VAE(F, L, h_dim), torch.Generator().manual_seed(0)).to(dev)
    mats = extract_decoder_mlp(model, L)
    rows_max = max(rows for _, rows, *_ in SEGMENTS)
    x2_all = torch.rand((rows_max, F), generator=gen, device=dev) + 0.05
    vb_all = torch.rand((rows_max, F), generator=gen, device=dev) + 0.05
    g_all = torch.rand((rows_max,), generator=gen, device=dev) + 0.5
    z0_all = 0.1 * torch.randn((rows_max, L), generator=gen, device=dev)

    def cuda_ms(fn, reps=20, warm=3):
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

    def via_table(on):
        """Hand the kernel the layer table at every depth (or at the depths
        past its arguments only, as the wrapper does); packs anew."""
        mh_chain._ARGS_DEPTH = 0 if on else args_depth
        mh_chain._PACKS.clear()

    has_stats = "fast_stats" in run_mh_chain.__code__.co_varnames
    if f32_routes:
        args_depth = mh_chain._ARGS_DEPTH
        if not 1 <= len(h_dim) <= args_depth:
            raise SystemExit(f"--f32-routes: depth {len(h_dim)} reads the table either way")
    out = {}
    for name, rows, wf, n_burn, n_samp in SEGMENTS:
        x2, vb, g, z0 = x2_all[:rows], vb_all[:rows], g_all[:rows], z0_all[:rows]
        noise = make_chain_noise(n_burn + n_samp, rows, L, gen, dev)
        args = (g, z0, None, noise, n_burn, n_samp, 0.01, wf, not f32_routes)
        x2h, vbh = x2.to(torch.bfloat16), vb if wf else vb.to(torch.bfloat16)
        runs = {"f32": lambda: run_mh_chain(mats, x2, vb, *args)}
        if has_stats:
            runs["bf16"] = lambda: run_mh_chain(mats, x2h, vbh, *args, fast_stats=True)
        for planes, run in runs.items():
            if not f32_routes:
                out[f"{name} {planes} planes"] = cuda_ms(run)
                continue
            got = {False: [], True: []}
            for table in (False, True, True, False):
                via_table(table)
                got[table].append(cuda_ms(run))
            via_table(False)
            for table, ms in got.items():
                out[f"{name} {planes} planes, f32 body, {'table' if table else 'arguments'}"] = (
                    sum(ms) / len(ms))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--h-dim", type=int, nargs="+", default=[128, 128])
    ap.add_argument("--f32-routes", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        root = os.path.abspath(args.roots[0])
        sys.path.insert(0, root)
        print(json.dumps(_time_root(tuple(args.h_dim), args.f32_routes)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chain_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    times = {root: [] for root in args.roots}
    for rnd in range(args.rounds):
        for root in (args.roots if rnd % 2 == 0 else args.roots[::-1]):
            done = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--child",
                                   "--h-dim", *map(str, args.h_dim),
                                   *(["--f32-routes"] if args.f32_routes else [])],
                                  capture_output=True, text=True, check=True)
            got = json.loads(done.stdout.strip().splitlines()[-1])
            times[root].append(got)
            print(f"{root}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in got.items()), flush=True)
    import statistics

    medians = {root: {k: statistics.median(run[k] for run in runs) for k in runs[0]}
               for root, runs in times.items()}
    print(json.dumps({"card": card, "h_dim": args.h_dim, "medians_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

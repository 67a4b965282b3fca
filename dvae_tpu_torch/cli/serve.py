"""Persistent enhancement server on the card (port of the JAX package's
``scripts/serve.py``).

    python -m dvae_tpu_torch.cli.serve --checkpoint M1.pt --port 8571
    curl -s --data-binary @noisy.wav 'localhost:8571/enhance' > s_est.wav
    curl -s --data-binary @noisy.wav 'localhost:8571/enhance?return=stereo' \\
        > both.wav   # ch0 speech + ch1 noise, sums to the input
    curl -sN --data-binary @long.wav 'localhost:8571/enhance?stream=1' \\
        | aplay      # with --chunk-seconds: the exact-length wav body
                     # streams as chunks finalize
    curl -s localhost:8571/healthz; curl -s localhost:8571/stats
    curl -s localhost:8571/metrics   # the same counters, Prometheus text
    curl -s -X POST 'localhost:8571/reload?checkpoint=/path/M1_new.pt'

The port binds at once and answers /healthz with the boot ledger
("booting", then "warming") while the model loads and one batch of each
warmup bucket runs (on the card this builds the kernels with nvcc);
requests arriving meanwhile queue behind the warmup. Concurrent requests
are merged into fixed-size ``Enhancer`` batches (padded with silence).
SIGTERM drains: everything admitted is answered, new requests get 503,
then the process exits 0. ``--platform cpu`` runs the plain PyTorch path
on the CPU; the default is the CUDA card. Checkpoints are ``.pt``
state_dicts.
"""

from __future__ import annotations

import argparse
import signal
import threading

from dvae_tpu_torch.cli._family import (
    add_mcem_budgets,
    add_model_family,
    load_family_model,
    mcem_config_of,
    norm_stats_if,
    warn_peem_family,
)
from dvae_tpu_torch.enhance.pipeline import _LATER


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_family(ap)
    add_mcem_budgets(ap)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 to accept remote clients)")
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="fixed device batch; concurrent requests micro-batch up to "
                         "this, the rest is silence padding")
    ap.add_argument("--batch-window-ms", type=float, default=25.0,
                    help="max wait to fill a micro-batch before dispatching")
    ap.add_argument("--y-source", default="self-soft", choices=["self-soft", "ones", "zeros"],
                    help="default labels for conditional classes (per-request override "
                         "via ?y_source=...)")
    ap.add_argument("--std-norm", action="store_true",
                    help="the model was trained with --std-norm; requires --norm-h5")
    ap.add_argument("--norm-h5", default=None,
                    help="h5 with X_train_mean/X_train_std for --std-norm (needs h5py)")
    ap.add_argument("--warmup-buckets", type=int, nargs="*", default=[64, 256],
                    help="frame buckets (multiples of 64) to run once before reporting "
                         "ready; 64 frames = 1 s, 256 = 4.1 s of audio. Empty = no warmup")
    ap.add_argument("--max-audio-seconds", type=float, default=600.0)
    ap.add_argument("--chunk-seconds", type=float, default=0.0,
                    help=">0: requests longer than this split into chunk items on the "
                         "same micro-batch queue (bounded device memory) and cross-fade "
                         "back")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission cap: pending requests beyond this get 503 + "
                         "Retry-After")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard each device batch over all visible devices (not served yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", choices=("cpu", "cuda"), default=None,
                    help="cpu runs the plain PyTorch path; default: the CUDA card")
    ap.add_argument("--admin-token", default=None,
                    help="require ?token=<value> on POST /reload; set it whenever --host "
                         "is not loopback (/reload loads checkpoint paths)")
    ap.add_argument("--verbose", action="store_true", help="log every HTTP request")
    args = ap.parse_args(argv)
    if not (args.checkpoint or args.model_dir):
        ap.error("need --checkpoint or --model-dir")
    if args.std_norm and not args.norm_h5:
        ap.error("--std-norm requires --norm-h5")
    if args.model_class in ("m2", "m2v2") and args.y_source == "self-soft":
        ap.error(f"{args.model_class} has no classifier; use --y-source ones/zeros")
    if args.data_parallel:
        ap.error("--data-parallel: " + _LATER.format(14))
    return args


def warmup_buckets(args) -> list[int]:
    """``--warmup-buckets`` plus, with ``--chunk-seconds``, the chunks' own
    bucket: every chunk item is exactly chunk-length (``chunk_spans``
    slides the final span back), so it runs in one bucket."""
    from dvae_tpu_torch.enhance.pipeline import EnhancerConfig
    from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped

    buckets = list(args.warmup_buckets)
    if args.chunk_seconds and buckets:
        stft, fb = StftConfig(), EnhancerConfig().frame_bucket
        chunk = max(stft.hop, round(args.chunk_seconds * stft.fs / stft.hop) * stft.hop)
        bucket = -(-n_stft_frames_clamped(chunk, stft) // fb) * fb
        if bucket not in buckets:
            buckets.append(bucket)
            print(f"auto-warming the {bucket}-frame chunk bucket "
                  f"(--chunk-seconds {args.chunk_seconds:g})")
    return buckets


def main(argv=None) -> None:
    # BootTimer first: it anchors at the process start, so the interpreter
    # and import segment is measured
    from dvae_tpu_torch.serving.boot import BootTimer, attach_service, bind_boot_server

    boot = BootTimer()
    args = parse_args(argv)
    # bind now: a readiness probe sees {"status": "booting", ...} instead of
    # connection-refused for the rest of the boot
    server = bind_boot_server(args.host, args.port, boot)
    svc = None
    warmup_failed = threading.Event()
    try:
        with boot.phase("imports"):
            import torch

            from dvae_tpu_torch.device import resolve_device
            from dvae_tpu_torch.enhance.pipeline import EnhancerConfig
            from dvae_tpu_torch.serving import EnhanceService, ServeConfig
        with boot.phase("backend_init"):
            device = resolve_device(args.platform)  # raises without a card
            if device.type == "cuda":
                torch.cuda.init()
        with boot.phase("model_load"):
            model, path = load_family_model(args)
            print(f"loaded {path}")
            norm = norm_stats_if(args)
        warn_peem_family(args, args.model_class, args.y_dim)
        buckets = warmup_buckets(args)
        y_mode = {"m1": "none", "m2": "enc_dec"}.get(args.model_class, "dec_only")
        with boot.phase("service_init"):
            svc = EnhanceService(
                model, args.model_class,
                enh_cfg=EnhancerConfig(mcem=mcem_config_of(args), y_mode=y_mode, norm=norm,
                                       engine=args.engine),
                cfg=ServeConfig(batch_size=args.batch_size,
                                batch_window_ms=args.batch_window_ms,
                                y_source=args.y_source, y_dim=args.y_dim, seed=args.seed,
                                max_audio_seconds=args.max_audio_seconds,
                                max_queue=args.max_queue, chunk_seconds=args.chunk_seconds,
                                warmup_buckets=tuple(buckets)),
                device=device)
        svc.boot = boot                          # /healthz carries the ledger
        if buckets:
            # clear before the handler goes live: a probe in the gap must
            # not see ready on a cold boot
            svc.ready.clear()
        attach_service(server, svc, verbose=args.verbose, admin_token=args.admin_token)
        boot.mark("service_attached")

        if buckets:
            print(f"warming {len(buckets)} bucket(s) in the background; /healthz "
                  "reports \"warming\" until done...", flush=True)
            boot.start("warmup")

            def _warm_done(err):
                boot.end("warmup")
                if err is None:
                    boot.mark_once("ready")
                    print(f"warm: {svc.warm_buckets} (ready "
                          f"{boot.snapshot()['marks']['ready']:.1f}s after process start)",
                          flush=True)
                else:
                    # the model cannot run at all: stop serving, exit nonzero
                    print(f"warmup FAILED: {err!r}", flush=True)
                    warmup_failed.set()
                    server.shutdown()

            svc.warmup_async(buckets, on_done=_warm_done)
        else:
            boot.mark("ready")

        def _drain_and_stop():
            drained = svc.drain()
            print("drained, stopping" if drained else "drain timed out, stopping", flush=True)
            server.shutdown()

        def _on_sigterm(signum, frame):
            # answer everything admitted (503 for new arrivals), then stop;
            # shutdown() must come from another thread than serve_forever's
            print("SIGTERM: draining...", flush=True)
            threading.Thread(target=_drain_and_stop, daemon=True).start()

        signal.signal(signal.SIGTERM, _on_sigterm)
        print(f"serving on http://{args.host}:{server.server_address[1]} "
              f"(model_class={args.model_class}, device={device}, batch={args.batch_size}, "
              f"window={args.batch_window_ms}ms)", flush=True)
        try:
            server._serve_thread.join()  # until shutdown(): drain, warmup failure
        except KeyboardInterrupt:
            pass
    finally:
        server.shutdown()
        server.server_close()
        if svc is not None:
            svc.close()
    if warmup_failed.is_set():
        raise SystemExit(1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device and build: the card's name and power limit, then the MH-chain
   kernel built from ``dvae_tpu_torch/csrc/mh_chain.cu``;
2. kernel against its plain PyTorch version on the card at full width
   (F 513, L 16, H 128/128): frozen chain, live E-step and WF segments fed
   the same noise, a conditioned row bias, the mismatch raise and a
   (128, 64) hidden stack;
3. the M1 ``Enhancer`` end to end on B = 32 synthetic ~5.1 s utterances at
   the full ``McemConfig()`` budget: the kernel's launch count must rise by
   exactly niter + 1, outputs must be finite; then the frozen-chain config
   runs once through the kernel and once through the plain chain, and masks
   and waveforms must agree, with the Wiener partition s + n = x;
4. times (CUDA events, warm): kernel and plain chain per E-step and WF
   segment at main-path shape, the NMF M-step, and the whole
   ``enhance_batch``, each with the card's name and power limit.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Weights are Xavier-normal from a seed;
the repo ships no checkpoint. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
B, SECONDS, FS = 32, 5.1, 16000
# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def synthetic_wavs(rng: np.random.Generator) -> list[np.ndarray]:
    """Harmonic 'speech' with a drifting pitch plus babble-like noise."""
    out = []
    for i in range(B):
        n = int(SECONDS * FS) - int(rng.integers(0, 3000))
        t = np.arange(n) / FS
        f0 = 110 + 60 * rng.random() + 20 * np.sin(2 * np.pi * 0.5 * t)
        phase = 2 * np.pi * np.cumsum(f0) / FS
        env = 0.5 + 0.5 * np.sin(2 * np.pi * (1.5 + rng.random()) * t) ** 2
        speech = env * sum(np.sin(k * phase) / k for k in range(1, 12))
        noise = rng.standard_normal(n) * (0.1 + 0.2 * rng.random())
        out.append((0.2 * speech + noise).astype(np.float32))
    return out


def chain_work(rows, f, l, h1, h2, n_burn, n_samples, wf):
    """(flops, bytes) one chain segment needs: every step decodes all rows
    (plus the initial decode); each input is read once and each output
    written once."""
    steps = n_burn + n_samples + 1
    macs = rows * steps * (l * h1 + h1 * h2 + h2 * f)
    # per (row, step, bin): exp, g*Vs+Vb, max, log, divide, add
    elem = rows * steps * f * 6 + (rows * n_samples * f * 5 if wf else 0)
    weights = l * h1 + h1 * h2 + h2 * f + h1 + h2 + f
    reads = 2 * rows * f + rows + rows * l + (steps - 1) * rows * (l + 1) + weights
    writes = rows * l + (2 * rows * f if wf else n_samples * rows * f)
    return 2 * macs + elem, 4 * (reads + writes)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dvae_tpu_torch.enhance import mcem, mh_chain
    from dvae_tpu_torch.enhance.mcem import McemConfig, run_mcem
    from dvae_tpu_torch.enhance.mh_chain import (
        extract_decoder_mlp,
        make_chain_noise,
        mh_chain_reference,
        run_mh_chain,
    )
    from dvae_tpu_torch.enhance.nmf import compute_vb, init_nmf, nmf_m_step
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import VAE
    from dvae_tpu_torch.models.blocks import init_xavier_
    from dvae_tpu_torch.ops.stft import stft_realimag

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # ---- 1. device and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    tag = f"[{card}]"
    t0 = time.perf_counter()
    mh_chain.build_library()
    log(f"phase 1: mh_chain kernel built in {time.perf_counter() - t0:.2f} s")

    # ---- 2. kernel vs plain on the card, full width
    f, l = 513, 16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def chain_problem(rows, h_dim=(128, 128)):
        model = init_xavier_(VAE(f, l, h_dim), torch.Generator().manual_seed(SEED)).to(dev)
        x2 = torch.rand((rows, f), generator=gen, device=dev) + 0.05
        vb = torch.rand((rows, f), generator=gen, device=dev) + 0.05
        g = torch.rand((rows,), generator=gen, device=dev) + 0.5
        z0 = 0.1 * torch.randn((rows, l), generator=gen, device=dev)
        return extract_decoder_mlp(model, l), x2, vb, g, z0

    def rel_err(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    rows = 4000  # not a multiple of the 16-row tile
    mats, x2, vb, g, z0 = chain_problem(rows)
    noise = make_chain_noise(5, rows, l, gen, dev)
    zk, sk = run_mh_chain(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0)
    zr, sr = mh_chain_reference(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0)
    sync()
    check(torch.equal(zk, z0), "frozen chain moved")
    err = rel_err(sk, sr)
    log(f"phase 2: frozen E-step chain, max rel err {err:.3e} (limit 1e-5)")
    check(err < 1e-5, "frozen chain: kernel vs plain")

    for wf in (False, True):
        for h_dim in ((128, 128), (128, 64)):
            mats_h, x2, vb, g, z0 = chain_problem(rows, h_dim)
            noise = make_chain_noise(12, rows, l, gen, dev)
            zk, *ok = run_mh_chain(mats_h, x2, vb, g, z0, None, noise, 6, 6, 0.01, wf)
            zr, *orf = mh_chain_reference(mats_h, x2, vb, g, z0, None, noise, 6, 6, 0.01, wf)
            sync()
            same = (zk - zr).abs().amax(-1) < 1e-4
            moved = float((zk != z0).any(-1).float().mean())
            errs = [rel_err(a[..., same, :], b[..., same, :]) for a, b in zip(ok, orf)]
            log(f"phase 2: live {'WF' if wf else 'E-step'} chain H={h_dim}: "
                f"{float(same.float().mean()):.4f} of rows end at the same z "
                f"(limit 0.99), {moved:.3f} moved, max rel err on them "
                f"{max(errs):.3e} (limit 1e-4)")
            check(float(same.float().mean()) > 0.99 and moved > 0.5 and max(errs) < 1e-4,
                  f"live chain wf={wf} H={h_dim}: kernel vs plain")

    w1y = 0.3 * torch.randn((2, 128), generator=gen, device=dev)
    cmats = (mats[0], w1y, *mats[2:])
    y = (torch.rand((rows, 2), generator=gen, device=dev) > 0.5).float()
    noise = make_chain_noise(1, rows, l, gen, dev)
    _, x2, vb, g, z0 = chain_problem(rows)
    _, sk = run_mh_chain(cmats, x2, vb, g, z0, y, noise, 0, 1, 0.0)
    _, sr = mh_chain_reference(cmats, x2, vb, g, z0, y, noise, 0, 1, 0.0)
    sync()
    err = rel_err(sk, sr)
    log(f"phase 2: conditioned row bias, max rel err {err:.3e} (limit 1e-5)")
    check(err < 1e-5, "conditioned chain: kernel vs plain")
    for bad_mats, bad_y in ((cmats, None), (mats, y)):
        try:
            run_mh_chain(bad_mats, x2, vb, g, z0, bad_y, noise, 0, 1, 0.0)
        except ValueError as e:
            check("conditioning mismatch" in str(e), f"mismatch message: {e}")
        else:
            raise RuntimeError("conditioning mismatch did not raise")
    log("phase 2: conditioning mismatch raises both ways")
    sync()

    # ---- 3. the M1 Enhancer end to end
    model = init_xavier_(VAE(513, 16, (128, 128)), torch.Generator().manual_seed(SEED))
    wavs = synthetic_wavs(np.random.default_rng(SEED))
    cfg = EnhancerConfig()
    enh = Enhancer(model, cfg)
    mh_chain.launches = 0
    t0 = time.perf_counter()
    out = enh.enhance_batch(wavs, seed=SEED)
    t_first = time.perf_counter() - t0
    launches = mh_chain.launches
    want = cfg.mcem.niter + 1
    log(f"phase 3: enhance_batch B={B} ran {launches} mh_chain launches "
        f"(expected niter + 1 = {want}), first call {t_first:.3f} s")
    check(launches == want, f"{launches} launches, expected {want}")
    check(len(out) == B and all(len(s) == len(x) == len(n) for (s, n), x in zip(out, wavs)),
          "output count and lengths")
    check(all(np.isfinite(s).all() and np.isfinite(n).all() for s, n in out), "finite outputs")
    cost = enh.last_cost
    check(cost.shape == (cfg.mcem.niter,) and np.isfinite(cost).all(), "finite cost trajectory")
    log(f"phase 3: cost {cost[0]:.5f} -> {cost[-1]:.5f}, outputs finite")

    # the padded batch as the main path sees it, for the comparisons and times
    xw, x_scale, mask, n_pad, frames = enh._prepare(wavs, None)
    with torch.inference_mode():
        x = xw.to(dev).float() * x_scale.to(dev)[:, None]
        re, im = stft_realimag(x, cfg.stft)
        x2b = (re * re + im * im)[:, :n_pad].contiguous()
        z0b = enh.model.encode(x2b, sample=False)[1]
    maskb = mask.to(dev)
    rows_main = B * n_pad

    @contextlib.contextmanager
    def plain_chain():
        """run_mcem's chain through the plain version, for the comparison only."""
        before = mh_chain.launches
        mcem.run_mh_chain = mh_chain_reference
        try:
            yield
        finally:
            mcem.run_mh_chain = run_mh_chain
        check(mh_chain.launches == before, "the plain run launched the kernel")

    frozen = McemConfig(var_rw=0.0)
    with torch.inference_mode():
        rk = run_mcem(enh.mats, x2b, z0b, maskb, SEED, frozen)
        with plain_chain():
            rp = run_mcem(enh.mats, x2b, z0b, maskb, SEED, frozen)
    sync()
    mask_err = max(float((rk.wfs - rp.wfs).abs().max()), float((rk.wfn - rp.wfn).abs().max()))
    cost_err = rel_err(rk.cost, rp.cost)
    part = float(((rk.wfs + rk.wfn - 1.0).abs() * maskb[:, :, None]).max())
    log(f"phase 3: frozen-chain run_mcem kernel vs plain: max mask diff {mask_err:.3e} "
        f"(limit 1e-3), max cost rel diff {cost_err:.3e} (limit 1e-4), "
        f"|WFs + WFn - 1| <= {part:.3e} on valid frames")
    check(mask_err < 1e-3 and cost_err < 1e-4 and part < 1e-5, "frozen run_mcem: kernel vs plain")

    # float32 wire, device-side noise estimate; compared where the ISTFT's
    # window normalizer is full (the first and last nfft samples of an
    # utterance divide by a normalizer down to ~1e-10, as in the reference)
    fcfg = EnhancerConfig(mcem=frozen, noise_from_partition=False, wire_dtype="float32")
    enh_k = Enhancer(model, fcfg)
    out_k = enh_k.enhance_batch(wavs, seed=SEED)
    with plain_chain():
        out_p = enh_k.enhance_batch(wavs, seed=SEED)
    wave_err, part_err = 0.0, 0.0
    nfft, hop = cfg.stft.nfft, cfg.stft.hop
    for (sk_, nk_), (sp_, _), xx, fr in zip(out_k, out_p, wavs, frames):
        peak = float(np.abs(xx).max())
        core = slice(nfft, min(len(xx), (fr - 1) * hop + nfft) - nfft)
        wave_err = max(wave_err, float(np.abs(sk_ - sp_)[core].max()) / peak)
        part_err = max(part_err, float(np.abs(sk_ + nk_ - xx)[core].max()) / peak)
    log(f"phase 3: frozen-chain enhance_batch kernel vs plain: max |s_k - s_p| / peak "
        f"{wave_err:.3e} (limit 1e-3); Wiener partition max |s + n - x| / peak "
        f"{part_err:.3e} on covered samples (limit 1e-4)")
    check(wave_err < 1e-3 and part_err < 1e-4, "frozen enhance_batch: kernel vs plain, partition")
    sync()

    # ---- 4. times at main-path shape
    def cuda_ms(fn, reps, warm=1):
        for _ in range(warm):
            fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    mc = cfg.mcem
    w, h, g = init_nmf(torch.Generator(device=dev).manual_seed(SEED), B, n_pad, f,
                       mc.nmf_rank, mc.eps, device=dev)
    vb_r = compute_vb(w, h).reshape(rows_main, f).contiguous()
    g_r = g.reshape(rows_main).contiguous()
    x2_r = x2b.reshape(rows_main, f)
    z_r = z0b.reshape(rows_main, l).contiguous()
    h1, h2 = enh.mats[0].shape[1], enh.mats[3].shape[1]
    times = {}
    for wf in (False, True):
        n_burn = mc.burnin_wf if wf else mc.burnin_e_step
        n_samp = mc.nsamples_wf if wf else mc.nsamples_e_step
        noise = make_chain_noise(n_burn + n_samp, rows_main, l, gen, dev)
        args = (enh.mats, x2_r, vb_r, g_r, z_r, None, noise, n_burn, n_samp, mc.var_rw, wf)
        k_ms = cuda_ms(lambda: run_mh_chain(*args), reps=10, warm=2)
        p_ms = cuda_ms(lambda: mh_chain_reference(*args), reps=3)
        flops, nbytes = chain_work(rows_main, f, l, h1, h2, n_burn, n_samp, wf)
        b_ms, b_by = bound_ms(flops, nbytes)
        times[wf] = (k_ms, p_ms, b_ms, b_by)
        log(f"phase 4: mh_chain {'WF' if wf else 'E-step'} segment rows={rows_main} "
            f"steps={n_burn}+{n_samp}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by} ({flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), kernel at {100 * b_ms / k_ms:.1f}% of bound {tag}")

    # max abs error of the kernel at main-path shape: frozen E-step segment
    noise = make_chain_noise(mc.burnin_e_step + mc.nsamples_e_step, rows_main, l, gen, dev)
    fargs = (enh.mats, x2_r, vb_r, g_r, z_r, None, noise, mc.burnin_e_step,
             mc.nsamples_e_step, 0.0)
    _, sk = run_mh_chain(*fargs)
    _, sr = mh_chain_reference(*fargs)
    sync()
    max_abs = float((sk - sr).abs().max())
    log(f"phase 4: frozen E-step segment at main-path shape: max abs err {max_abs:.3e}, "
        f"max rel err {rel_err(sk, sr):.3e}")
    check(rel_err(sk, sr) < 1e-5, "frozen segment at main-path shape")

    vs_s = torch.rand((mc.nsamples_e_step, B, n_pad, f), generator=gen, device=dev) + 0.05
    m_ms = cuda_ms(lambda: nmf_m_step(x2b, vs_s, w, h, g, maskb, mc.eps), reps=5)
    log(f"phase 4: nmf_m_step R={mc.nsamples_e_step} B={B} N={n_pad}: {m_ms:.4f} ms {tag}")

    walls = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        enh.enhance_batch(wavs, seed=SEED)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    chain_s = (mc.niter * times[False][0] + times[True][0]) / 1e3
    log(f"phase 4: enhance_batch B={B} wall {', '.join(f'{t:.4f}' for t in walls)} s "
        f"(median {wall:.4f} s, {B / wall:.2f} utt/s) {tag}")
    log(f"phase 4: breakdown of the median: chain kernel {chain_s:.4f} s "
        f"({100 * chain_s / wall:.1f}%), M-step {mc.niter * m_ms / 1e3:.4f} s "
        f"({100 * mc.niter * m_ms / 1e3 / wall:.1f}%), rest "
        f"{wall - chain_s - mc.niter * m_ms / 1e3:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")

    k_ms, p_ms, b_ms, b_by = times[False]
    log(json.dumps({"kernels": [{
        "name": "mh_chain", "route": "cuda", "source": "dvae_tpu_torch/csrc/mh_chain.cu",
        "replaces": "dvae_tpu/enhance/pallas_mcem.py:112", "launches": launches,
        "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

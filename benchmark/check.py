"""The comparison that decides ``correct``.

The program's MCEM is a Markov chain: two correct implementations that
round in a different order part ways once one accept decision flips, so
after a hundred EM iterations their outputs differ by Monte-Carlo noise
however right both are. The reference therefore follows the program step
by step from the program's own state, as recorded in the window
(``probe.Probe``): each stage gets the inputs the program's stage got, and
its output is compared with the program's. The stages that start the chain
(the wire, the STFT power, the encoder, the labels) are checked from the
benchmark's own mixtures, and the tail (Wiener masking, ISTFT, PCM16
wire) up to the answers the caller received. Two numbers tie the stages
together: ``links_bad`` counts the EM iterations missing from ``niter``
and every hand-over where a stage did not get what the one before it gave
(the latents, the gains, W and H, the Vb and x2 planes, the samples), and
``noise_z`` holds the chain noise the program drew, which the reference
replays, to its law (standard normal steps, uniform acceptance draws).

Each number has a limit (``workloads/<cell>.json``), set from the
program's readings over many seeds and the control's (the reference one
precision step lower, put in the program's place: :func:`numbers` with
``control=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dsp, mcem
from benchmark.reference.precision import (BF16_BITS, LOWERED, STATED, Float32Products,
                                           round_bits)

# a row of a chain segment agrees when its latent is within this of the
# reference's (40 f32 steps differ by a few ulps) ...
Z_TOL = 1e-4
# ... and each emitted bf16 sample within two of its ulps (the two sides
# round f32 values that may differ by ~1e-3 relative)
VS_TOL = 2.0 ** -6
# a Wiener mask (a mean of 25 ratios in [0, 1]) agrees within this
MASK_TOL = 2e-3
# a Vb plane handed to the chain agrees with W @ H of the state it was
# handed within half a bf16 ulp plus rounding, or f32 rounding
VB_TOL = {True: 2.0 ** -8, False: 1e-5}

#: planted faults of the chain noise, for the readings of ``noise_z``'s
#: upper end: the walk's steps at 1.1025x their variance, and the
#: acceptance draws' log u scaled by 1.05 (u^1.05, mean 0.488)
NOISE_FAULTS = {
    "walk_var": lambda eps, logu: (eps * 1.05, logu),
    "log_u": lambda eps, logu: (eps, logu * 1.05),
}


def _rel(a, b, dims) -> torch.Tensor:
    """Per leading index, ||a - b|| / ||b|| over ``dims`` (||a - b|| where
    b is all zero)."""
    a, b = a.double(), b.double()
    d = (a - b).pow(2).sum(dims).sqrt()
    n = b.pow(2).sum(dims).sqrt()
    return torch.where(n > 0, d / n.clamp_min(1e-300), d)


def _worst(values) -> float:
    vals = [float(v) for v in values]
    return max(vals) if vals else float("inf")


def _frames_mask(frames, n_pad, device):
    mask = torch.zeros((len(frames), n_pad), device=device)
    for i, f in enumerate(frames):
        mask[i, :f] = 1.0
    return mask


def _valid_rel(a, b, frames) -> float:
    """The worst utterance's relative gap over its valid frames."""
    return _worst(_rel(a[i, :f], b[i, :f], (0, 1)) for i, f in enumerate(frames))


def _chain_mismatch_rows(z_c, z_r, vs_c, vs_r) -> torch.Tensor:
    """Rows of an E-step segment whose latent or any emitted sample leaves
    the tolerances."""
    dz = (z_c - z_r).abs().amax(-1) > Z_TOL * (1 + z_r.abs().amax(-1))
    vs_c, vs_r = vs_c.float(), vs_r.float()
    dv = ((vs_c - vs_r).abs() > VS_TOL * vs_r.abs()).any(0).any(-1)
    return dz | dv


def numbers(rec: dict, outputs: list, weights: dict, cfg: dict, ref, control: bool = False,
            side: dict | None = None, label_weights: dict | None = None) -> dict:
    """``{name: value}`` of the recorded dispatch ``rec``: the program's
    gaps to the reference, or with ``control`` the control's. ``outputs``
    holds the caller's (s_hat, n_hat) per recorded utterance (None for a
    batch filler no caller waits for). A configuration whose labels come
    from a label network of its own (``labels.source`` "net") also needs
    that network's weights and ``side``, ``{input: [one per recorded
    utterance]}`` (None for a filler). A stage the record lacks reads
    infinity."""
    with Float32Products(), torch.inference_mode():
        return _numbers(rec, outputs, weights, cfg, ref, control, side or {}, label_weights)


def _numbers(rec, outputs, weights, cfg, ref, control, side, label_weights):
    st = dsp.Stft(**cfg["stft"])
    mc, enh = cfg["mcem"], cfg["enhancer"]
    fast = mc["fast_decoder"] and len(cfg["model"]["h_dim"]) == 2
    fs_ = mc["fast_stats"]
    cand_prec = LOWERED if control else None
    dev = next(iter(weights.values())).device
    out = {}
    inf = float("inf")
    wavs = rec.get("wavs")
    ein, eout = rec.get("engine_in"), rec.get("engine_out")
    if not wavs or ein is None or eout is None:
        return {k: inf for k in ("power_rel", "encoder_rel", "estep_mismatch_pct",
                                 "mstep_rel", "wf_mismatch_pct", "tail_quanta", "links_bad",
                                 "noise_z")}

    def pick(stage, program):
        """The candidate at a stage: the program's output, or the control's."""
        return stage(cand_prec) if control else program

    # -- the start: the wire and the STFT power the engine got -----------------
    x, frames, n_pad = dsp.pack(wavs, st, enh["frame_bucket"], dev)
    q, scale = dsp.pcm16(x)
    xw = q * scale[:, None]

    def x2_of(prec):
        return dsp.power(xw, st, n_pad, prec)

    x2_ref = x2_of(STATED)
    x2_prog = ein["x2"].float()
    if x2_prog.shape != x2_ref.shape:
        out["power_rel"] = inf
    else:
        out["power_rel"] = _valid_rel(pick(x2_of, x2_prog), x2_ref, frames)
    # -- the encoder, from the program's power (and, for an encoder that sees
    # [x; y], the labels the engine got) ----------------------------------------
    x2_in = x2_prog if x2_prog.shape == x2_ref.shape else x2_ref
    y_prog = ein["y"]
    enc_dec = enh["y_mode"] == "enc_dec"

    def enc(prec):
        if enc_dec:
            return ref.encoder_mean(weights, cfg, x2_in, prec, y_prog.float())
        return ref.encoder_mean(weights, cfg, x2_in, prec)

    z_prog = ein["z"].float()
    out["encoder_rel"] = (_valid_rel(pick(enc, z_prog), enc(STATED), frames)
                          if z_prog.shape[:2] == x2_in.shape[:2]
                          and not (enc_dec and y_prog is None) else inf)
    # -- the labels: B2's power of the raw mixtures, then the classifier; or
    # the configuration's own label network ---------------------------------------
    if cfg.get("labels"):
        if cfg["labels"]["source"] == "net":
            out["labels_gap"] = _net_labels_gap(wavs, outputs, y_prog, frames, cfg, ref, side,
                                                label_weights, control)
        else:
            out.update(_label_numbers(rec, wavs, outputs, y_prog, frames, weights, cfg, ref,
                                      st, dev, control))
    # -- the chain segments and M-steps of the recorded iterations ---------------
    dec = ref.decoder(weights, cfg)
    y_rows = None if y_prog is None else y_prog.reshape(-1, y_prog.shape[-1]).float()

    def by_of(prec):
        return mcem.row_bias(dec, y_rows, fast, prec)

    bad, rows = 0, 0
    for rec_e in rec["estep"].values():
        if (rec_e["n_burn"], rec_e["n_samples"]) != (mc["burnin_e_step"], mc["nsamples_e_step"]):
            bad, rows = 1, 1
            break

        def seg(prec, r=rec_e):
            return mcem.segment(dec, by_of(prec), r["x2"], r["vb"], r["g"], r["z"], r["noise"],
                                r["n_burn"], r["n_samples"], mc["var_rw"], False, fast, fs_, prec)

        z_r, vs_r = seg(STATED)
        z_c, vs_c = pick(seg, rec_e["out"])
        bad += int(_chain_mismatch_rows(z_c, z_r, vs_c, vs_r).sum())
        rows += z_r.shape[0]
    out["estep_mismatch_pct"] = 100.0 * bad / rows if rows else inf
    gaps = []
    for rec_m in rec["mstep"].values():
        def mstep(prec, r=rec_m):
            return mcem.m_step(r["x2"], r["vs"], r["w"], r["h"], r["g"], r["mask"], mc["eps"],
                               fs_, prec)

        want = mstep(STATED)
        got = pick(mstep, rec_m["out"])
        gaps += [_worst(_rel(a, b, tuple(range(1, b.dim())))) for a, b in zip(got, want)]
    out["mstep_rel"] = _worst(gaps)
    # -- the Wiener segment and the masks the engine returned ---------------------
    wf = rec.get("wf")
    mask = _frames_mask(frames, n_pad, dev)
    if wf is None or (wf["n_burn"], wf["n_samples"]) != (mc["burnin_wf"], mc["nsamples_wf"]):
        out["wf_mismatch_pct"] = inf
        wfs_prog = eout["wfs"]
    else:
        def wf_seg(prec):
            z, s, _ = mcem.segment(dec, by_of(prec), wf["x2"], wf["vb"], wf["g"], wf["z"],
                                   wf["noise"], wf["n_burn"], wf["n_samples"], mc["var_rw"],
                                   True, fast, fs_, prec)
            return z, s.reshape(mask.shape + s.shape[-1:]) / wf["n_samples"] * mask[..., None]

        z_r, m_r = wf_seg(STATED)
        z_c, m_c = wf_seg(cand_prec) if control else (wf["out"][0], eout["wfs"])
        rows_bad = ((z_c - z_r).abs().amax(-1) > Z_TOL * (1 + z_r.abs().amax(-1))
                    ) | ((m_c - m_r).abs().amax(-1) > MASK_TOL).reshape(-1)
        out["wf_mismatch_pct"] = 100.0 * float(rows_bad.float().mean())
        wfs_prog = eout["wfs"]
    # -- the hand-overs between the stages, and the noise the reference replays --
    out["links_bad"] = float(_links(rec, ein, mc, cfg["model"]["z_dim"]))
    out["noise_z"] = noise_z(rec, cfg["model"]["z_dim"])
    # -- the tail: masking, ISTFT, PCM16, the caller's answers --------------------
    out["tail_quanta"] = _tail(wfs_prog, xw, mask, frames, n_pad, wavs, outputs, st,
                               cand_prec if control else None)
    return out


def _label_numbers(rec, wavs, outputs, y_prog, frames, weights, cfg, ref, st, dev, control):
    """B2's power of the callers' mixtures zero-padded to the longest (no
    wire), and the classifier's labels from the program's power."""
    inf = float("inf")
    out = {"b2_power_rel": inf, "labels_gap": inf}
    live = [i for i, o in enumerate(outputs) if o is not None]
    lens = [len(wavs[i]) for i in live]
    n = st.frames(max(lens))
    xb = np.zeros((len(live), max(st.samples(n), max(lens))), np.float32)
    for row, i in enumerate(live):
        xb[row, :lens[row]] = wavs[i]
    xb = torch.from_numpy(xb).to(dev)

    def pw(prec):
        return dsp.power(xb, st, n, prec)

    p_ref = pw(STATED)
    power = rec.get("power")
    if power is None or tuple(power[1].shape) != tuple(p_ref.shape):
        return out
    p_prog = power[1].float()
    out["b2_power_rel"] = _valid_rel(pw(LOWERED) if control else p_prog, p_ref,
                                     [st.frames(t) for t in lens])
    if y_prog is None:
        return out
    b, nn, f = p_prog.shape

    def lab(prec):
        return ref.labels(weights, cfg, p_prog.reshape(b * nn, f), prec).reshape(b, nn, -1)

    y_ref = lab(STATED)
    y_c = lab(LOWERED) if control else None
    gaps = []
    for row, i in enumerate(live):
        f_i = min(frames[i], nn)
        got = y_c[row, :f_i] if control else y_prog[i, :f_i].float()
        gaps.append(float((got - y_ref[row, :f_i]).abs().max()))
    out["labels_gap"] = _worst(gaps)
    return out


def _net_labels_gap(wavs, outputs, y_prog, frames, cfg, ref, side, label_weights,
                    control) -> float:
    """The largest gap, over the valid frames of the callers' mixtures,
    between the labels the engine got and the reference's label network
    (``ref.net_labels``) on those mixtures and the side inputs paired with
    them."""
    live = [i for i, o in enumerate(outputs) if o is not None]
    if y_prog is None or label_weights is None or not live:
        return float("inf")
    ws = [wavs[i] for i in live]
    sd = {k: [v[i] for i in live] for k, v in side.items()}
    want = ref.net_labels(label_weights, cfg, ws, sd, STATED)
    got_c = ref.net_labels(label_weights, cfg, ws, sd, LOWERED) if control else None
    gaps = []
    for row, i in enumerate(live):
        f_i = min(frames[i], y_prog.shape[1])
        if want[row].shape[0] < f_i:
            return float("inf")
        got = got_c[row][:f_i] if control else y_prog[i, :f_i].float()
        gaps.append(float((got - want[row][:f_i]).abs().max()))
    return _worst(gaps)


def _tail(wfs, xw, mask, frames, n_pad, wavs, outputs, st, lowered) -> float:
    """The largest gap, in PCM16 quanta of the reference's scale, between
    the answers and the reference's masking, ISTFT and wire from the
    program's masks."""
    def answers(prec):
        re, im = dsp.stft(xw, st, n_pad, prec)
        s = dsp.istft_masked(wfs * re, wfs * im, mask, st, prec)
        q, scale = dsp.pcm16(s)
        return dsp.finalize(q, scale, wavs, frames, st), scale.cpu().numpy()

    want, scale = answers(STATED)
    got = answers(lowered)[0] if lowered is not None else outputs
    gaps = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            continue
        s, n = (np.asarray(a, np.float32) for a in g)
        if s.shape != w[0].shape or n.shape != w[1].shape or not (
                np.isfinite(s).all() and np.isfinite(n).all()):
            return float("inf")
        gap = max(float(np.abs(s - w[0]).max(initial=0.0)), float(np.abs(n - w[1]).max(initial=0.0)))
        gaps.append(gap / max(float(scale[i]), 1e-30))
    return _worst(gaps)


def _same(a, b) -> bool:
    """``a`` and ``b`` hold the same values (as float32, shapes as rows)."""
    a, b = a.float(), b.float()
    return a.numel() == b.numel() and torch.equal(a.reshape(b.shape), b)


def _vb_ok(plane, w, h, half: bool) -> bool:
    """The Vb ``plane`` the chain got is W @ H of ``(w, h)`` (float64 here),
    within :data:`VB_TOL` of each value."""
    want = torch.einsum("bnk,bfk->bnf", h.double(), w.double()).reshape(-1, w.shape[1])
    got = plane.double()
    return got.shape == want.shape and bool(
        ((got - want).abs() <= VB_TOL[half] * want.abs() + 1e-30).all())


def _links(rec, ein, mc, l) -> int:
    """The EM iterations the recorded dispatch is short of (or over) its
    ``niter`` E-step segments, M-steps and one Wiener segment, plus every
    broken hand-over: each segment's latents are the previous segment's
    (the encoder's at the first), its gains and Vb plane are those of the
    M-step state it runs on, each M-step starts from the previous one's
    result, the drawn iterations' M-steps read their segment's samples, the
    engine's x2 and mask, and the segments the x2 plane; the Wiener
    segment runs on the last latents and the last M-step's result."""
    niter, half = mc["niter"], mc["fast_stats"]
    chains, msteps = rec.get("chain_log", []), rec.get("mstep_log", [])
    bad = abs(len(chains) - niter) + abs(len(msteps) - niter) + abs(rec.get("wf_calls", 0) - 1)
    x2 = ein["x2"].float()
    plane = round_bits(x2.reshape(-1, x2.shape[-1]), BF16_BITS if half else None)
    z = ein["z"].float().reshape(-1, l)
    for it in range(min(len(chains), len(msteps))):
        c, m = chains[it], msteps[it]
        bad += not _same(c["z"], z)
        z = c["z_out"]
        bad += not _same(c["g"], m["in"][2])
        if it:
            bad += sum(not _same(a, b) for a, b in zip(m["in"], msteps[it - 1]["out"]))
        vb = c.get("vb", rec["estep"].get(it, {}).get("vb"))
        if vb is not None:
            bad += not _vb_ok(vb, m["in"][0], m["in"][1], half)
    for it, e in rec["estep"].items():
        bad += not _same(e["x2"], plane)
        r = rec["mstep"].get(it)
        if r is not None:
            bad += not _same(r["vs"], e["out"][1])
            bad += not (_same(r["x2"], x2) and _same(r["mask"], ein["mask"]))
    wf = rec.get("wf")
    if wf is not None and msteps and len(chains) == len(msteps):
        w, h, g = msteps[-1]["out"]
        bad += not _same(wf["z"], z)
        bad += not _same(wf["g"], g)
        bad += not _vb_ok(wf["vb"], w, h, False)
        bad += not _same(wf["x2"], plane)
    return bad


def noise_z(rec, l, fault=None) -> float:
    """The largest departure, in standard errors, of the recorded chain
    noise (every recorded segment's, pooled) from its law: the mean and
    second moment of the walk's standard normal steps, and of u =
    exp(log u), uniform on [0, 1). ``fault`` names one of
    :data:`NOISE_FAULTS`, planted in the noise."""
    segs = [r["noise"] for r in rec["estep"].values()]
    if rec.get("wf") is not None:
        segs.append(rec["wf"]["noise"])
    if not segs:
        return float("inf")
    sums = torch.zeros(4, dtype=torch.float64, device=segs[0].device)
    n = m = 0
    for nz in segs:
        eps, logu = nz[..., :l].double(), nz[..., l].double()
        if fault is not None:
            eps, logu = NOISE_FAULTS[fault](eps, logu)
        if not (torch.isfinite(eps).all() and torch.isfinite(logu).all()) or (logu > 0).any():
            return float("inf")
        u = logu.exp()
        sums += torch.stack([eps.sum(), eps.pow(2).sum(), u.sum(), (u - 0.5).pow(2).sum()])
        n, m = n + eps.numel(), m + u.numel()
    e1, e2, u1, u2 = sums.tolist()
    zs = (e1 / n * n ** 0.5, (e2 / n - 1.0) / (2.0 / n) ** 0.5,
          (u1 / m - 0.5) / (1.0 / (12 * m)) ** 0.5,
          (u2 / m - 1.0 / 12) / (1.0 / (180 * m)) ** 0.5)
    return max(abs(v) for v in zs)


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    without a limit, or a limit without a number, fails."""
    names = sorted(set(nums) | set(limits))
    table = {k: {"value": nums.get(k, float("inf")), "limit": limits.get(k)} for k in names}
    ok = all(v["limit"] is not None and np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table

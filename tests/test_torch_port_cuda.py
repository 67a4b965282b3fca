"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Every test marked ``cuda`` skips without a CUDA device (the kernels have
no CPU mode). The chain runs in both bodies: ``f32`` (fast_decoder=False)
and ``bf16`` (fast_decoder=True, the tensor-core body), each against the
plain chain of the same precision. Tolerances, f32: a frozen chain (var_rw
= 0) is the same decoder arithmetic in another summation order, rtol 1e-5.
A live chain fed the same noise may flip an acceptance where ``log u``
lies within rounding of ``E - E'``, so at least 99% of rows must end at
the same z, and those rows' samples agree to rtol 1e-4. bf16: the two
sides round the same operands to bf16, but sum in another order, so a
tanh output within rounding of a bf16 rounding boundary can round the
other way and move its row's Vs by up to ~1e-3 relative; so Vs agrees to
5e-3 relative everywhere and to 1e-5 on at least 99% of the elements, in
a frozen chain and on the rows of a live chain that end at the same z
(again at least 99%); ``run_mcem``'s outputs, smooth functions of Vs,
agree to rtol 5e-3. The STFT power kernel takes an FFT where the
plain version takes matmuls, so the two round differently: power agrees to
rtol 1e-4 above a floor of 1e-6 of the batch's peak power, log power to
1e-3 absolute on the bins above that floor; a silent row gives exactly 0,
or log(eps).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from dvae_tpu_torch.data.builders import build_frames
from dvae_tpu_torch.data.datasets import FrameDataset
from dvae_tpu_torch.enhance import mh_chain
from dvae_tpu_torch.enhance.mcem import McemConfig, run_mcem
from dvae_tpu_torch.enhance.mh_chain import (
    extract_decoder_mlp,
    make_chain_noise,
    mh_chain_reference,
    run_mh_chain,
)
from dvae_tpu_torch.enhance.pipeline import EnhancerConfig
from dvae_tpu_torch.models import CVAE, CVAE_v3, CVAE_v4, VAE, DisentangledVAE
from dvae_tpu_torch.ops import log_power_spectrogram, power_spectrogram, stft_power
from dvae_tpu_torch.ops.stft import StftConfig, padded_length
from dvae_tpu_torch.serving import EnhanceService, ServeConfig
from dvae_tpu_torch.train.loop import LoopConfig, fit_adversarial, fit_semisup, fit_vae

F, L = 513, 16
PRECISIONS = pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _close(a, b, fast, rtol=1e-5, atol=1e-6):
    """Kernel against plain: at ``rtol``/``atol`` for the f32 body, by the
    bf16 rule of the module docstring for the tensor-core body."""
    if not fast:
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        return
    rel = (a - b).abs() / b.abs().clamp_min(1e-30)
    assert float(rel.max()) < 5e-3 and float((rel < 1e-5).float().mean()) >= 0.99


def _problem(dev, rows, h_dim=(128, 128), seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tm = VAE(F, L, h_dim).to(dev)
    x2 = torch.rand((rows, F), generator=gen, device=dev) + 0.05
    vb = torch.rand((rows, F), generator=gen, device=dev) + 0.05
    g = torch.rand((rows,), generator=gen, device=dev) + 0.5
    z0 = 0.1 * torch.randn((rows, L), generator=gen, device=dev)
    return extract_decoder_mlp(tm, L), x2, vb, g, z0, gen


@pytest.mark.cuda
@PRECISIONS
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_frozen_chain_matches_plain(cuda, wf_mode, fast):
    mats, x2, vb, g, z0, gen = _problem(cuda, 1000)  # not a tile multiple
    noise = make_chain_noise(5, 1000, L, gen, cuda)
    before, before_mma = mh_chain.launches, mh_chain.launches_mma
    out = run_mh_chain(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0, wf_mode, fast)
    torch.cuda.synchronize()
    assert mh_chain.launches == before + 1
    assert mh_chain.launches_mma == before_mma + fast
    ref = mh_chain_reference(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0, wf_mode, fast)
    assert torch.equal(out[0], z0)
    for a, b in zip(out[1:], ref[1:]):
        _close(a, b, fast)


@pytest.mark.cuda
@PRECISIONS
@pytest.mark.parametrize("h_dim", [(128, 128), (128, 64)], ids=["square", "nonsquare"])
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_live_chain_matches_plain(cuda, h_dim, wf_mode, fast):
    mats, x2, vb, g, z0, gen = _problem(cuda, 4096, h_dim, seed=1)
    noise = make_chain_noise(8, 4096, L, gen, cuda)
    zk, *ok = run_mh_chain(mats, x2, vb, g, z0, None, noise, 4, 4, 0.01, wf_mode, fast)
    zr, *orf = mh_chain_reference(mats, x2, vb, g, z0, None, noise, 4, 4, 0.01, wf_mode, fast)
    same = (zk - zr).abs().amax(-1) < 1e-4
    assert same.float().mean() > 0.99
    assert (zk != z0).any(-1).float().mean() > 0.5  # the chain explores
    for a, b in zip(ok, orf):
        _close(a[..., same, :], b[..., same, :], fast, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@PRECISIONS
def test_cuda_conditioned_bias_and_mismatch(cuda, fast):
    mats, x2, vb, g, z0, gen = _problem(cuda, 512, seed=2)
    w1y = 0.3 * torch.randn((2, mats[0].shape[1]), generator=gen, device=cuda)
    cmats = (mats[0], w1y, *mats[2:])
    y = torch.rand((512, 2), generator=gen, device=cuda)  # soft labels
    noise = make_chain_noise(1, 512, L, gen, cuda)
    _, sk = run_mh_chain(cmats, x2, vb, g, z0, y, noise, 0, 1, 0.0, fast_decoder=fast)
    _, sr = mh_chain_reference(cmats, x2, vb, g, z0, y, noise, 0, 1, 0.0, fast_decoder=fast)
    _close(sk, sr, fast)
    with pytest.raises(ValueError, match="conditioning mismatch"):
        run_mh_chain(cmats, x2, vb, g, z0, None, noise, 0, 1, 0.0, fast_decoder=fast)
    with pytest.raises(ValueError, match="conditioning mismatch"):
        run_mh_chain(mats, x2, vb, g, z0, y, noise, 0, 1, 0.0, fast_decoder=fast)


@pytest.mark.cuda
@PRECISIONS
def test_cuda_run_mcem_frozen_matches_plain(cuda, monkeypatch, fast):
    """run_mcem through the kernel vs through the plain chain on the card."""
    b, n = 4, 64
    mats, x2, _, _, z0, _ = _problem(cuda, b * n, seed=3)
    x2, z0 = x2.reshape(b, n, F), z0.reshape(b, n, L)
    mask = torch.ones((b, n), device=cuda)
    mask[1, 40:] = 0.0
    cfg = McemConfig(niter=5, nsamples_e_step=3, burnin_e_step=2, nsamples_wf=4,
                     burnin_wf=2, var_rw=0.0, fast_decoder=fast)
    before = mh_chain.launches
    rk = run_mcem(mats, x2, z0, mask, 7, cfg)
    assert mh_chain.launches == before + cfg.niter + 1
    from dvae_tpu_torch.enhance import mcem

    monkeypatch.setattr(mcem, "run_mh_chain", mh_chain_reference)
    rp = run_mcem(mats, x2, z0, mask, 7, cfg)
    assert mh_chain.launches == before + cfg.niter + 1
    for a, b_ in zip(rk, rp):
        torch.testing.assert_close(a, b_, rtol=5e-3 if fast else 1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_default_config_runs_the_bf16_body(cuda):
    """McemConfig() (fast_decoder=True) launches the tensor-core body at
    every segment: niter E-step segments and one WF segment."""
    b, n = 2, 32
    mats, x2, _, _, z0, _ = _problem(cuda, b * n, seed=4)
    cfg = McemConfig()
    assert cfg.fast_decoder
    before, before_mma = mh_chain.launches, mh_chain.launches_mma
    res = run_mcem(mats, x2.reshape(b, n, F), z0.reshape(b, n, L),
                   torch.ones((b, n), device=cuda), 0, cfg)
    torch.cuda.synchronize()
    assert mh_chain.launches_mma == before_mma + cfg.niter + 1
    assert mh_chain.launches == before + cfg.niter + 1
    assert torch.isfinite(res.wfs).all() and torch.isfinite(res.cost).all()


@pytest.mark.cuda
@PRECISIONS
def test_cuda_tensors_never_take_the_plain_chain(cuda, monkeypatch, fast):
    """A CUDA tensor launches the selected body; the plain chain is not
    reached, whatever the precision."""
    def plain(*args, **kw):
        raise AssertionError("the plain chain ran on CUDA tensors")

    monkeypatch.setattr(mh_chain, "mh_chain_reference", plain)
    mats, x2, vb, g, z0, gen = _problem(cuda, 64, seed=5)
    noise = make_chain_noise(3, 64, L, gen, cuda)
    before_mma = mh_chain.launches_mma
    z, s = run_mh_chain(mats, x2, vb, g, z0, None, noise, 1, 2, 0.01, fast_decoder=fast)
    torch.cuda.synchronize()
    assert mh_chain.launches_mma == before_mma + fast
    assert s.shape == (2, 64, F) and torch.isfinite(s).all()


@pytest.mark.cuda
@PRECISIONS
@pytest.mark.parametrize("family", ["v5-self-soft", "m2-ibm"])
def test_cuda_conditioned_enhancer_frozen_matches_plain(cuda, monkeypatch, fast, family):
    """The conditioned Enhancer (DisentangledVAE, dec_only, self-soft labels
    from one STFT power launch; CVAE, enc_dec, binary labels at y_dim 513)
    with a frozen chain, through the kernel and through the plain chain:
    enhanced waveforms within 1e-3 of the peak and s + n = x within 1e-4 of
    it, away from the ISTFT's edges (chip_smoke.py phase 3's limits)."""
    from dvae_tpu_torch.enhance import mcem
    from dvae_tpu_torch.enhance.labeling import self_soft_labels
    from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
    from dvae_tpu_torch.models import CVAE, DisentangledVAE
    from dvae_tpu_torch.ops.stft import n_stft_frames_clamped

    rng = np.random.default_rng(8)
    ws = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 9000, 12345)]
    if family == "v5-self-soft":
        model, y_mode = DisentangledVAE(F, 1, L, (128, 128)).to(cuda), "dec_only"
        before = stft_power.launches
        ys = self_soft_labels(model, ws, StftConfig(), 1, "classify_from_x")
        assert stft_power.launches == before + 1
    else:
        model, y_mode = CVAE(F, 513, L, (128, 128)), "enc_dec"
        ys = [(rng.uniform(size=(n_stft_frames_clamped(len(w), StftConfig()), 513)) > 0.5)
              .astype(np.float32) for w in ws]
    frozen = McemConfig(niter=3, nsamples_e_step=2, burnin_e_step=2, nsamples_wf=2,
                        burnin_wf=2, var_rw=0.0, fast_decoder=fast)
    enh = Enhancer(model, EnhancerConfig(mcem=frozen, y_mode=y_mode, wire_dtype="float32"))
    before = mh_chain.launches
    out_k = enh.enhance_batch(ws, ys, seed=1)
    assert mh_chain.launches == before + frozen.niter + 1
    monkeypatch.setattr(mcem, "run_mh_chain", mh_chain_reference)
    out_p = enh.enhance_batch(ws, ys, seed=1)
    assert mh_chain.launches == before + frozen.niter + 1
    nfft = StftConfig().nfft
    for (sk, nk), (sp, _), x in zip(out_k, out_p, ws):
        peak, core = np.abs(x).max(), slice(nfft, len(x) - 2 * nfft)
        assert np.isfinite(sk).all() and np.isfinite(nk).all()
        assert np.abs(sk - sp)[core].max() < 1e-3 * peak
        assert np.abs(sk + nk - x)[core].max() < 1e-4 * peak


# chain launches of each engine, from its config
ENGINE_LAUNCHES = {"run_pmcem": lambda cfg: cfg.niter + 1, "run_peem_wf": lambda cfg: 1,
                   "run_peem": lambda cfg: 0, "run_em_fixed_z": lambda cfg: 0}


def _engine_problem(cuda, fast, seed=6):
    b, n = 4, 64
    mats, x2, _, _, z0, _ = _problem(cuda, b * n, seed=seed)
    mask = torch.ones((b, n), device=cuda)
    mask[1, 40:] = 0.0
    cfg = McemConfig(niter=4, nsamples_e_step=3, burnin_e_step=2, nsamples_wf=4,
                     burnin_wf=2, var_rw=0.0, fast_decoder=fast, pmcem_chains=3,
                     pmcem_steps=3, pmcem_wf_burn=2, peem_steps=2)
    return mats, x2.reshape(b, n, F), z0.reshape(b, n, L), mask, cfg


@pytest.mark.cuda
@PRECISIONS
@pytest.mark.parametrize("engine", ["run_pmcem", "run_peem_wf"])
def test_cuda_frozen_engine_matches_plain(cuda, monkeypatch, fast, engine):
    """Frozen pmcem (all chains at z_init, as the R x B*N rows of each
    segment) and frozen peem-wf through the kernel and through the plain
    chain on the card, with run_mcem's limits: rtol 1e-4 (f32 body) or 5e-3
    (bf16 body); their launch counts, niter + 1 and 1."""
    from dvae_tpu_torch.enhance import mcem

    mats, x2, z0, mask, cfg = _engine_problem(cuda, fast)
    want = cfg.niter + 1 if engine == "run_pmcem" else 1
    before, before_mma = mh_chain.launches, mh_chain.launches_mma
    rk = getattr(mcem, engine)(mats, x2, z0, mask, 7, cfg)
    torch.cuda.synchronize()
    assert mh_chain.launches == before + want
    assert mh_chain.launches_mma == before_mma + (want if fast else 0)
    monkeypatch.setattr(mcem, "run_mh_chain", mh_chain_reference)
    rp = getattr(mcem, engine)(mats, x2, z0, mask, 7, cfg)
    assert mh_chain.launches == before + want
    for a, b_ in zip(rk, rp):
        torch.testing.assert_close(a, b_, rtol=5e-3 if fast else 1e-4, atol=1e-5)
    part = (rk.wfs + rk.wfn - 1.0).abs() * mask[:, :, None]
    assert float(part.max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(ENGINE_LAUNCHES))
def test_cuda_engines_never_take_the_plain_chain(cuda, monkeypatch, engine):
    """Every engine on CUDA tensors launches the kernel for each MH segment
    (pmcem niter + 1, peem-wf 1, PEEM and the pinned latent none) and never
    reaches the plain chain; outputs finite, the Wiener partition holds."""
    from dvae_tpu_torch.enhance import mcem

    def plain(*args, **kw):
        raise AssertionError("the plain chain ran on CUDA tensors")

    monkeypatch.setattr(mh_chain, "mh_chain_reference", plain)
    mats, x2, z0, mask, cfg = _engine_problem(cuda, True, seed=9)
    cfg = dataclasses.replace(cfg, var_rw=0.01)
    before = mh_chain.launches
    res = getattr(mcem, engine)(mats, x2, z0, mask, 3, cfg)
    torch.cuda.synchronize()
    assert mh_chain.launches - before == ENGINE_LAUNCHES[engine](cfg)
    assert all(bool(torch.isfinite(t).all()) for t in res)
    part = (res.wfs + res.wfn - 1.0).abs() * mask[:, :, None]
    assert float(part.max()) < 1e-5


def _quirk_length():
    """A multiple of hop at which the end-pad quirk still adds a hop."""
    return next(n for n in range(256 * 40, 256 * 120, 256)
                if padded_length(n, StftConfig()) != n)


def _tone(gen, batch, length):
    t = torch.arange(length, device=gen.device) / 16000.0
    return 0.3 * torch.sin(2 * torch.pi * 220 * t) + 0.2 * torch.randn(
        (batch, length), generator=gen, device=gen.device)


def _check_stft(got, p, log_out):
    """Kernel output against the plain power ``p``, at the stated limits."""
    assert got.shape == p.shape
    floor = 1e-6 * p.amax()
    if log_out:
        big = p > floor
        assert (got[big] - torch.log(p[big] + 1e-12)).abs().max() < 1e-3
    else:
        torch.testing.assert_close(got, p, rtol=1e-4, atol=float(floor))


@pytest.mark.cuda
@pytest.mark.parametrize("log_out", [False, True], ids=["power", "log"])
@pytest.mark.parametrize("center", [False, True], ids=["nocenter", "center"])
def test_cuda_stft_power_matches_plain(cuda, center, log_out):
    cfg = StftConfig(center=center)
    gen = torch.Generator(device=cuda).manual_seed(5)
    # frame counts that are not a multiple of any block's frames, the
    # end-pad quirk, a batch, a launch large enough for 32 frames per block
    # (>= 8 such blocks per SM), and (centered) a signal shorter than nfft / 2;
    # then the FFT's edges: a silent row beside a full-scale one, and the
    # fewest frames a signal gives (one uncentred, two centred)
    cases = [_tone(gen, 1, 20480), _tone(gen, 3, 12345), _tone(gen, 2, _quirk_length()),
             _tone(gen, 1, 81600), _tone(gen, 128, 81600)]
    cases += [_tone(gen, 2, 300)] if center else []
    edges = _tone(gen, 3, 20480)
    edges[1] = 0.0
    edges[2] = torch.where(edges[2] > 0, 1.0, -1.0)
    cases += [edges, _tone(gen, 1, 200 if center else 769)]
    runs = []
    for x in cases:
        before = stft_power.launches
        got = log_power_spectrogram(x, cfg) if log_out else power_spectrogram(x, cfg)
        torch.cuda.synchronize()
        assert stft_power.launches == before + 1
        p = stft_power.stft_power_reference(x, cfg)
        assert stft_power.launches == before + 1  # the plain version launches nothing
        _check_stft(got, p, log_out)
        runs.append((got, p))
    assert runs[-1][0].shape[-2] == (2 if center else 1)
    (got, p), _ = runs[-2:]  # the silent row: 0, or log(eps) as the plain version gives it
    assert not p[1].any()
    assert torch.equal(got[1], torch.log(p[1] + 1e-12) if log_out else p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,hop", [(256, 64), (512, 128), (2048, 512), (1024, 251),
                                      (1024, 1)])
def test_cuda_stft_power_other_framings(cuda, nfft, hop):
    """Every frame size the kernel is built for, an odd hop (unaligned
    frames) and a hop of one sample; the shared memory the wrapper checks
    is the kernel's own."""
    cfg = StftConfig(wlen_sec=nfft / 16000, hop_percent=hop / nfft, center=False,
                     pad_at_end=False)
    assert (cfg.nfft, cfg.hop) == (nfft, hop)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _tone(gen, 3, 3 * nfft + 77 if hop > 1 else nfft + 300)
    for log_out in (False, True):
        got = stft_power._launch(x, cfg, 1e-12 if log_out else None)
        _check_stft(got, stft_power.stft_power_reference(x, cfg), log_out)
    lib = stft_power.build_library()
    assert lib.stft_power_warps() == stft_power._WARPS
    for fpb in (8, 32):
        assert lib.stft_power_smem_bytes(nfft, hop, fpb) == stft_power._smem_bytes(nfft, hop, fpb)


def test_stft_power_dispatch_raises_off_cpu_and_cuda():
    x = torch.zeros((2, 4096), device="meta")
    before = stft_power.launches
    for fn in (power_spectrogram, log_power_spectrogram):
        with pytest.raises(ValueError, match="unsupported device meta"):
            fn(x, StftConfig())
    assert stft_power.launches == before


@pytest.mark.cuda
def test_cuda_build_frames_one_launch_matches_cpu(cuda):
    """The frame-set builder makes one kernel launch for all utterances and
    gives the plain version's frames and statistics."""
    rng = np.random.default_rng(9)
    wavs = [rng.standard_normal(n) for n in (_quirk_length(), 16000, 81600, 11111)]
    before = stft_power.launches
    got = build_frames(wavs, device=cuda)
    assert stft_power.launches == before + 1
    want = build_frames(wavs, device="cpu")
    assert got.counts == want.counts
    torch.testing.assert_close(torch.from_numpy(got.x), torch.from_numpy(want.x),
                               rtol=1e-4, atol=float(1e-6 * want.x.max()))
    torch.testing.assert_close(torch.from_numpy(got.mean), torch.from_numpy(want.mean),
                               rtol=1e-4, atol=0.0)


@PRECISIONS
def test_mh_chain_dispatch_raises_off_cpu_and_cuda(fast):
    x2 = torch.zeros((32, F), device="meta")
    mats = (torch.zeros((L, 128), device="meta"), None, *(
        torch.zeros(shape, device="meta") for shape in ((128,), (128, 128), (128,), (128, F), (F,))))
    before = mh_chain.launches
    with pytest.raises(ValueError, match="unsupported device meta"):
        run_mh_chain(mats, x2, x2, torch.zeros(32, device="meta"),
                     torch.zeros((32, L), device="meta"), None,
                     torch.zeros((1, 32, L + 1), device="meta"), 0, 1, 0.0, fast_decoder=fast)
    assert mh_chain.launches == before


def _noisy_wav(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["m1", "v5-self-soft"])
def test_cuda_service_answers_through_the_kernels(cuda, monkeypatch, family):
    """A CUDA EnhanceService answers one request with exactly niter + 1
    launches of the MH-chain kernel (bf16 body) and, for a self-soft batch,
    one STFT power launch; the plain chain is never reached."""
    def plain(*args, **kw):
        raise AssertionError("the plain chain ran on CUDA tensors")

    monkeypatch.setattr(mh_chain, "mh_chain_reference", plain)
    cfg = McemConfig(niter=5)
    torch.manual_seed(0)
    if family == "m1":
        model, enh = VAE(F, L, (128, 128)), EnhancerConfig(mcem=cfg)
    else:
        model, enh = DisentangledVAE(F, 1, L, (128, 128)), EnhancerConfig(mcem=cfg,
                                                                          y_mode="dec_only")
    svc = EnhanceService(model, family.split("-")[0], enh,
                         ServeConfig(batch_size=4, warmup_buckets=()))
    try:
        assert svc.device.type == "cuda"
        x = _noisy_wav(2.0)
        chain, mma, stft = mh_chain.launches, mh_chain.launches_mma, stft_power.launches
        s, n = svc.submit(x, timeout=600)
        assert mh_chain.launches - chain == mh_chain.launches_mma - mma == cfg.niter + 1
        assert stft_power.launches - stft == (family != "m1")
        assert s.shape == n.shape == x.shape and np.isfinite(s).all()
        assert np.median(np.abs(s + n - x)[1024:-1024]) < 5e-3
    finally:
        svc.close()


@pytest.mark.cuda
def test_cuda_service_warmup_builds_the_kernels_or_fails(cuda, monkeypatch):
    """Warmup on the card runs the kernels (building them when missing) and
    then reports ready; when the build fails, the warmup fails, and nothing
    is served through the plain chain."""
    torch.manual_seed(0)
    cfg = EnhancerConfig(mcem=McemConfig(niter=3))
    svc = EnhanceService(VAE(F, L, (128, 128)), "m1", cfg,
                         ServeConfig(batch_size=2, warmup_buckets=(64,)))
    try:
        before = mh_chain.launches
        svc.warmup()
        assert svc.warm_buckets == [64] and svc.warmup_error is None
        assert mh_chain.launches - before == 4
        assert mh_chain.build_library() is not None
    finally:
        svc.close()

    def no_nvcc():
        raise RuntimeError("nvcc failed for mh_chain.cu")

    def plain(*args, **kw):
        raise AssertionError("the plain chain ran on CUDA tensors")

    monkeypatch.setattr(mh_chain, "build_library", no_nvcc)
    monkeypatch.setattr(mh_chain, "mh_chain_reference", plain)
    svc = EnhanceService(VAE(F, L, (128, 128)), "m1", cfg,
                         ServeConfig(batch_size=2, warmup_buckets=(64,)))
    try:
        done = []
        svc.warmup_async(on_done=done.append)
        assert svc._worker.is_alive()
        deadline = time.monotonic() + 60
        while not done and time.monotonic() < deadline:
            time.sleep(0.01)
        assert done and "nvcc failed" in str(done[0]) and svc.warmup_error is done[0]
        assert not svc.ready.is_set() and svc.warm_buckets == []
    finally:
        svc.close()


def _labelled_wavs():
    t = np.arange(40000) / 16000
    rng = np.random.default_rng(12)
    out = []
    for k, n in enumerate((_quirk_length(), 16000, 40000, 11111)):
        s = np.sin(2 * np.pi * (150 + 30 * k) * t[:n]) * (np.sin(2 * np.pi * 1.1 * t[:n]) > 0)
        out.append((0.3 * s + 1e-3 * rng.standard_normal(n)).astype(np.float32))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["vad_labels", "ibm_labels"])
def test_cuda_labelled_build_frames_one_launch_matches_cpu(cuda, labels):
    """The labelled frame set costs one kernel launch. VAD labels equal the
    CPU path's; IBM labels, taken from the kernel's power, disagree on at
    most 1e-4 of the bins, and only where the CPU path's dB value lies
    within 1e-3 dB of its utterance's threshold."""
    wavs = _labelled_wavs()
    before = stft_power.launches
    got = build_frames(wavs, device=cuda, labels=labels)
    assert stft_power.launches == before + 1
    want = build_frames(wavs, device="cpu", labels=labels)
    assert got.counts == want.counts and got.y.shape == want.y.shape
    if labels == "vad_labels":
        np.testing.assert_array_equal(got.y, want.y)
        return
    db = 20.0 * np.log10(np.sqrt(want.x.astype(np.float64)) + 1e-8)
    start, margin = 0, np.empty_like(db)
    for n in want.counts:
        margin[start:start + n] = db[start:start + n] - (db[start:start + n].max() - 50.0)
        start += n
    off = got.y != want.y
    assert off.mean() <= 1e-4 and (np.abs(margin[off]) < 1e-3).all()


def _labelled_set(n, y_dim, seed):
    rng = np.random.default_rng(seed)
    x = (np.abs(rng.standard_normal((n, F))) + 0.1).astype(np.float32)
    return FrameDataset.from_arrays(x, (rng.uniform(size=(n, y_dim)) > 0.5).astype(np.float32),
                                    x.mean(0)[:, None], x.std(0)[:, None])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["v5", "v4"])
def test_cuda_fit_adversarial_few_steps(cuda, tmp_path, layout):
    model = (DisentangledVAE if layout == "v5" else CVAE_v4)(F, 1, L, (128, 128))
    train, valid = _labelled_set(640, 1, 1), _labelled_set(256, 1, 2)
    best, hist = fit_adversarial(model, train, valid, tmp_path, "M2_info", 0.0, 10.0, 1.0,
                                 cfg=LoopConfig(batch_size=128, end_epoch=3, device_data=True),
                                 y_cond=None if layout == "v5" else "hardlabel")
    assert next(model.parameters()).device.type == "cuda"
    assert all(np.isfinite(list(h["train"].values()) + list(h["valid"].values())).all()
               for h in hist)
    assert all(torch.isfinite(v).all() for v in best.values())
    assert len(list(tmp_path.glob("M2_info_epoch_*.opt.pt"))) == 2


@pytest.mark.cuda
def test_cuda_fit_semisup_and_conditional_few_steps(cuda, tmp_path):
    train, valid = _labelled_set(640, 1, 3), _labelled_set(256, 1, 4)
    cfg = LoopConfig(batch_size=128, end_epoch=3)
    _, hist = fit_semisup(CVAE_v3(F, 1, L, (128, 128)), train, valid, tmp_path / "ss",
                          "M2v3", "uloss", 10.0, cfg=cfg)
    assert all(np.isfinite(list(h["valid"].values())).all() for h in hist)
    ibm_train, ibm_valid = _labelled_set(640, 513, 5), _labelled_set(256, 513, 6)
    _, hist = fit_vae(CVAE(F, 513, L, (128, 128)), ibm_train, ibm_valid, tmp_path / "m2",
                      "M2", conditional=True, cfg=cfg)
    assert all(np.isfinite(h["valid"]["elbo"]) for h in hist)

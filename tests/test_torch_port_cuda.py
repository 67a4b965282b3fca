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
agree to rtol 5e-3. At ``fast_stats=True`` both sides emit bf16 samples,
each rounding its own f32 Vs, so an element whose two values straddle a
bf16 boundary differs by one bf16 ulp (``_close_emitted``); the tests
that hold the kernel to the f32 limits above pass ``fast_stats=False``.
The STFT power kernel takes an FFT where the
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
    DecoderMats,
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
    w1y = 0.3 * torch.randn((2, mats.widths[0]), generator=gen, device=cuda)
    cmats = mats._replace(w1y=w1y)
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
                     burnin_wf=2, var_rw=0.0, fast_decoder=fast, fast_stats=False)
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
    before_res = mh_chain.launches_resident
    res = run_mcem(mats, x2.reshape(b, n, F), z0.reshape(b, n, L),
                   torch.ones((b, n), device=cuda), 0, cfg)
    torch.cuda.synchronize()
    assert mh_chain.launches_mma == before_mma + cfg.niter + 1
    assert mh_chain.launches == before + cfg.niter + 1
    # the E-step segments (bf16 planes) in the resident layout, not the WF one
    assert mh_chain.launches_resident == before_res + cfg.niter
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
                        burnin_wf=2, var_rw=0.0, fast_decoder=fast, fast_stats=False)
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


def _engine_problem(cuda, fast, seed=6, fast_stats=False):
    b, n = 4, 64
    mats, x2, _, _, z0, _ = _problem(cuda, b * n, seed=seed)
    mask = torch.ones((b, n), device=cuda)
    mask[1, 40:] = 0.0
    cfg = McemConfig(niter=4, nsamples_e_step=3, burnin_e_step=2, nsamples_wf=4,
                     burnin_wf=2, var_rw=0.0, fast_decoder=fast, pmcem_chains=3,
                     pmcem_steps=3, pmcem_wf_burn=2, peem_steps=2, fast_stats=fast_stats)
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


def _close_emitted(a, b, fast):
    """bf16 samples (fast_stats) of the kernel against the plain chain's:
    each side rounds its f32 Vs, so an element whose two values straddle a
    bf16 boundary differs by one bf16 ulp (at most 2^-7 relative). f32
    body: at most 1e-3 of the elements differ, by at most that; bf16 body:
    its own 5e-3 on top, on at most 1.1e-2 of the elements (its 1% share
    and the flips)."""
    assert a.dtype == b.dtype == torch.bfloat16
    a, b = a.float(), b.float()
    rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    differ = float((a != b).float().mean())
    if fast:
        assert rel < 5e-3 + 2.0 ** -7 and differ <= 1.1e-2
    else:
        assert rel <= 2.0 ** -7 and differ <= 1e-3


@pytest.mark.cuda
@PRECISIONS
@pytest.mark.parametrize("var_rw", [0.0, 0.01], ids=["frozen", "live"])
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_fast_stats_chain_matches_plain(cuda, wf_mode, var_rw, fast):
    """fast_stats: the kernel reads bf16 x2 (and Vb in E-step mode, f32 in
    WF mode, rounded at the energy) and emits bf16 samples, against the
    plain chain on the same planes: rows that end at the same z (all of a
    frozen chain's, >= 99% of a live one's) emit by :func:`_close_emitted`
    and sum their Wiener masks to rtol 1e-4 (f32) or by the bf16 rule;
    WFs + WFn = n_samples to rtol 1e-5."""
    rows = 4096
    mats, x2, vb, g, z0, gen = _problem(cuda, rows, seed=10)
    x2h, vbh = x2.to(torch.bfloat16), vb if wf_mode else vb.to(torch.bfloat16)
    noise = make_chain_noise(8, rows, L, gen, cuda)
    args = (mats, x2h, vbh, g, z0, None, noise, 4, 4, var_rw, wf_mode, fast)
    before, before_res = mh_chain.launches, mh_chain.launches_resident
    zk, *ok = run_mh_chain(*args, fast_stats=True)
    torch.cuda.synchronize()
    assert mh_chain.launches == before + 1
    assert mh_chain.launches_resident == before_res + (fast and not wf_mode)
    zr, *orf = mh_chain_reference(*args, fast_stats=True)
    same = (zk - zr).abs().amax(-1) < 1e-4
    assert same.float().mean() > (0.999 if var_rw == 0.0 else 0.99)
    if var_rw:
        assert (zk != z0).any(-1).float().mean() > 0.5
    if wf_mode:
        for a, b in zip(ok, orf):
            _close(a[same], b[same], fast, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(ok[0] + ok[1], torch.full_like(ok[0], 4.0), rtol=1e-5,
                                   atol=0)
    else:
        _close_emitted(ok[0][:, same], orf[0][:, same], fast)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["m1", "row-bias", "wide-range"])
def test_cuda_resident_layout_matches_the_shared_layout_bit_for_bit(cuda, monkeypatch, case):
    """E-step segments on bf16 planes run the resident layout; the shared
    layout, forced on the same inputs, gives the same z and samples bit for
    bit: the same products, sums and roundings in the same order. Rows not
    a tile multiple, a folded row bias, and planes across f32's range (the
    division's slow path)."""
    rows = 2000 if case == "wide-range" else 1000
    mats, x2, vb, g, z0, gen = _problem(cuda, rows, seed=13)
    if case == "row-bias":
        y = torch.rand((rows, 2), generator=gen, device=cuda)
        w1y = 0.3 * torch.randn((2, mats.widths[0]), generator=gen, device=cuda)
        mats = mh_chain.fold_conditioning(mats._replace(w1y=w1y), y, True)
    if case == "wide-range":
        x2 = x2 * 10.0 ** (torch.rand((rows, F), generator=gen, device=cuda) * 75 - 40)
        x2[:, ::7] = 0.0
        vb = vb * 10.0 ** (torch.rand((rows, F), generator=gen, device=cuda) * 37 - 12)
    noise = make_chain_noise(8, rows, L, gen, cuda)
    args = (mats, x2.to(torch.bfloat16), vb.to(torch.bfloat16), g, z0, None, noise, 4, 4, 0.01,
            False, True)
    assert mh_chain.chain_layout(mats, F, L, False, True, True) == "resident"
    before = mh_chain.launches_resident
    z_res, s_res = run_mh_chain(*args, fast_stats=True)
    torch.cuda.synchronize()
    assert mh_chain.launches_resident == before + 1
    layout = mh_chain._layout
    monkeypatch.setattr(mh_chain, "_layout", lambda *a: max(layout(*a), 1))
    z_sh, s_sh = run_mh_chain(*args, fast_stats=True)
    torch.cuda.synchronize()
    assert mh_chain.launches_resident == before + 1
    assert torch.equal(z_res, z_sh) and torch.equal(s_res, s_sh)
    if case != "wide-range":
        assert (z_res != z0).any(-1).float().mean() > 0.5  # a live chain


@pytest.mark.cuda
def test_cuda_fast_stats_lean_layout_matches_plain(cuda):
    """The bf16 body at (256, 256) in WF mode runs the lean layout (WF sums in
    global memory), fast_stats on: frozen, against the plain chain."""
    mats, x2, vb, g, z0, gen = _problem(cuda, 1000, (256, 256), seed=11)
    assert mh_chain.chain_layout(mats, F, L, True, True) == "lean"
    noise = make_chain_noise(5, 1000, L, gen, cuda)
    args = (mats, x2.to(torch.bfloat16), vb, g, z0, None, noise, 2, 3, 0.0, True, True)
    zk, *ok = run_mh_chain(*args, fast_stats=True)
    zr, *orf = mh_chain_reference(*args, fast_stats=True)
    assert torch.equal(zk, z0)
    for a, b in zip(ok, orf):
        _close(a, b, True)


@pytest.mark.cuda
@PRECISIONS
@pytest.mark.parametrize("engine", ["run_mcem", "run_pmcem", "run_peem_wf"])
def test_cuda_fast_stats_frozen_engine_matches_plain(cuda, monkeypatch, fast, engine):
    """The default fast_stats=True: a frozen engine through the kernel and
    through the plain chain on the card, each with niter + 1 (peem-wf 1)
    launches, outputs at rtol 1e-3 (f32 body: one-ulp flips of the bf16
    samples and R-sums move W by ~5e-4 over the EM iterations) or 5e-3
    (bf16 body), and the Wiener partition."""
    from dvae_tpu_torch.enhance import mcem

    mats, x2, z0, mask, cfg = _engine_problem(cuda, fast, seed=12, fast_stats=True)
    want = 1 if engine == "run_peem_wf" else cfg.niter + 1
    before = mh_chain.launches
    rk = getattr(mcem, engine)(mats, x2, z0, mask, 7, cfg)
    torch.cuda.synchronize()
    assert mh_chain.launches == before + want
    monkeypatch.setattr(mcem, "run_mh_chain", mh_chain_reference)
    rp = getattr(mcem, engine)(mats, x2, z0, mask, 7, cfg)
    assert mh_chain.launches == before + want
    for a, b_ in zip(rk, rp):
        torch.testing.assert_close(a, b_, rtol=5e-3 if fast else 1e-3, atol=1e-5)
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
    mats, x2, z0, mask, cfg = _engine_problem(cuda, True, seed=9, fast_stats=True)
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
    w1z, b1, w2, b2, w3, b3 = (torch.zeros(shape, device="meta") for shape in (
        (L, 128), (128,), (128, 128), (128,), (128, F), (F,)))
    mats = DecoderMats(w1z, None, b1, ((w2, b2),), w3, b3)
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


# ---------------------------------------------------------------------------
# steps_per_dispatch > 1: one CUDA graph over K steps
# ---------------------------------------------------------------------------

K_STEPS = 8
STEP_KINDS = ["m1", "m2-ibm", "semisup", "adversarial"]


def _k_step_pair(kind, seed=0):
    """A model with a capturable, gradient-keeping train step, built the same
    way twice from one seed: (model, step, optimizers, y_dim)."""
    from dvae_tpu_torch.models.blocks import init_xavier_
    from dvae_tpu_torch.train.steps import (adam, init_adversarial_state, make_adversarial_step,
                                            make_semisup_step, make_train_step)

    make = {"m1": lambda: VAE(F, L, (128, 128)), "m2-ibm": lambda: CVAE(F, 513, L, (128, 128)),
            "semisup": lambda: CVAE_v3(F, 1, L, (128, 128)),
            "adversarial": lambda: DisentangledVAE(F, 1, L, (128, 128))}[kind]
    model = init_xavier_(make(), torch.Generator().manual_seed(seed)).cuda()
    if kind == "adversarial":
        opts = init_adversarial_state(model, 1e-4, capturable=True)
        step = make_adversarial_step(model, *opts, 0.0, 10.0, 1.0, keep_grads=True)
    else:
        opts = (adam(model.parameters(), 1e-4, capturable=True),)
        step = (make_semisup_step(model, opts[0], "uloss", 10.0, keep_grads=True)
                if kind == "semisup" else
                make_train_step(model, opts[0], kind != "m1", keep_grads=True))
    return model, step, opts, {"m1": 0, "m2-ibm": 513}.get(kind, 1)


def _adam_state(opts):
    return [(k, v) for o in opts for st in o.state.values() for k, v in sorted(st.items())]


@pytest.mark.cuda
@pytest.mark.parametrize("fed", ["host", "device"])
@pytest.mark.parametrize("kind", STEP_KINDS)
def test_cuda_multistep_graph_matches_eager_steps(cuda, kind, fed):
    """One replay of the K-step graph against K eager calls of the same step
    on a twin model with the same capturable Adam and the same generator
    state: metrics (rtol 1e-5), weights and Adam moments (2e-6 absolute),
    over three dispatches (the eager warm-up, then two replays) with the
    generator re-seeded in place before the last. Prints whether each
    agreed bitwise."""
    from dvae_tpu_torch.train.steps import MultiStep

    model_a, step_a, opts_a, y_dim = _k_step_pair(kind)
    model_b, step_b, opts_b, _ = _k_step_pair(kind)
    rng = np.random.default_rng(5)
    n = 4 * K_STEPS * 128
    x_all = torch.from_numpy((np.abs(rng.standard_normal((n, F))) + 0.1).astype(np.float32)).cuda()
    y_all = (torch.from_numpy((rng.uniform(size=(n, y_dim)) > 0.5).astype(np.float32)).cuda()
             if y_dim else None)
    multi = MultiStep(step_a, opts_a, (x_all, y_all) if fed == "device" else None)
    ga = torch.Generator(device=cuda).manual_seed(11)
    gb = torch.Generator(device=cuda).manual_seed(11)
    bitwise = []
    for d in range(3):
        if d == 2:
            ga.manual_seed(12)
            gb.manual_seed(12)
        idx = torch.from_numpy(rng.permutation(n)[:K_STEPS * 128].reshape(K_STEPS, 128)).cuda()
        xs = x_all[idx]
        ys = None if y_all is None else y_all[idx]
        got = (multi(idx, None, generator=ga) if fed == "device" else
               multi(xs.cpu().pin_memory(), None if ys is None else ys.cpu().pin_memory(),
                     generator=ga))
        want = torch.stack([torch.stack(list(step_b(xs[k], None if ys is None else ys[k],
                                                    generator=gb).values()))
                            for k in range(K_STEPS)])
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)
        same = torch.equal(got, want)
        for (na, pa), (_, pb) in zip(model_a.state_dict().items(), model_b.state_dict().items()):
            np.testing.assert_allclose(pa.cpu().numpy(), pb.cpu().numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{na} dispatch {d}")
            same = same and torch.equal(pa, pb)
        for (k, va), (_, vb) in zip(_adam_state(opts_a), _adam_state(opts_b)):
            np.testing.assert_allclose(va.cpu().numpy(), vb.cpu().numpy(), rtol=1e-5, atol=2e-6)
            same = same and torch.equal(va.cpu(), vb.cpu())
        bitwise.append(same)
    print(f"{kind} {fed}-fed graph vs eager K={K_STEPS}: bitwise per dispatch {bitwise}")
    assert len(multi._graphs) == 1


def _k_fit(kind, model_dir, cfg, device="cuda"):
    data = {"m1": 0, "m2-ibm": 513}.get(kind, 1)
    train, valid = _labelled_set(2500, max(data, 1), 7), _labelled_set(300, max(data, 1), 8)
    if kind == "m1":
        model = VAE(F, L, (128, 128))
        return model, fit_vae(model, train, valid, model_dir, "M1", cfg=cfg, device=device)
    if kind == "m2-ibm":
        model = CVAE(F, 513, L, (128, 128))
        return model, fit_vae(model, train, valid, model_dir, "M2", conditional=True, cfg=cfg,
                              device=device)
    if kind == "semisup":
        model = CVAE_v3(F, 1, L, (128, 128))
        return model, fit_semisup(model, train, valid, model_dir, "M2", "uloss", 10.0, cfg=cfg,
                                  device=device)
    model = DisentangledVAE(F, 1, L, (128, 128))
    return model, fit_adversarial(model, train, valid, model_dir, "M2", 0.0, 10.0, 1.0,
                                  cfg=cfg, device=device)


def _fit_gap(a, b, hist_a, hist_b):
    """(largest weight difference, largest relative metric difference) of
    two fits."""
    w = max(float((va - vb).abs().max())
            for va, vb in zip(a.state_dict().values(), b.state_dict().values()))
    m = max(abs(ha[part][k] - hb[part][k]) / max(abs(hb[part][k]), 1e-30)
            for ha, hb in zip(hist_a, hist_b) for part in ("train", "valid") for k in ha[part])
    return w, m


def _fits_agree(a, b, hist_a, hist_b):
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_allclose(va.cpu().numpy(), vb.cpu().numpy(), rtol=0, atol=2e-6,
                                   err_msg=k)
    for ha, hb in zip(hist_a, hist_b):
        for part in ("train", "valid"):
            for k in ha[part]:
                np.testing.assert_allclose(ha[part][k], hb[part][k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{part} {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("device_data", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("kind", ["m1", "semisup", "adversarial"])
def test_cuda_fit_k8_matches_k1(cuda, tmp_path, monkeypatch, kind, device_data):
    """A whole fit at K = 8 against K = 1: 19 full batches of 128 per epoch
    go as dispatches of 8, 8 and 3 (two graphs, each first run eagerly as
    its warm-up, then replayed), the ragged batch of 68 alone; the same
    batches and noise. Against a K = 1 run whose Adams are capturable too,
    the weights and every metric are bitwise the same. Against the default
    K = 1 run (Adam's bias correction in f32 on the card against f64 on the
    host) M1 and the semisup step stay within the train-step tolerances;
    the adversarial game amplifies that rounding beyond them (measured:
    9.5e-6 on 0.4% of the first-layer weights after two epochs), so its
    gap is printed."""
    from dvae_tpu_torch.train import loop

    cfg = LoopConfig(batch_size=128, end_epoch=3, seed=3, device_data=device_data)
    m8, (_, h8) = _k_fit(kind, tmp_path / "k8",
                         LoopConfig(**{**cfg.__dict__, "steps_per_dispatch": K_STEPS}))
    m1, (_, h1) = _k_fit(kind, tmp_path / "k1", cfg)
    with monkeypatch.context() as mp:
        mp.setattr(loop, "_capturable", lambda dev, multi: dev.type == "cuda")
        mc, (_, hc) = _k_fit(kind, tmp_path / "k1c", cfg)
    assert hc == h8
    assert all(torch.equal(v, m8.state_dict()[k]) for k, v in mc.state_dict().items())
    gap = _fit_gap(m8, m1, h8, h1)
    print(f"{kind} {'device' if device_data else 'host'}-fed fit K={K_STEPS} vs K=1 "
          f"(default Adam): max weight diff {gap[0]:.3e}, max metric rel diff {gap[1]:.3e}")
    if kind != "adversarial":
        _fits_agree(m8, m1, h8, h1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["m1", "adversarial"])
def test_cuda_resume_changes_steps_per_dispatch(cuda, tmp_path, kind):
    """A K = 1 checkpoint resumes into a K = 8 run (Adam made capturable,
    its step counts moved to the card) and a K = 8 checkpoint into a K = 1
    run (back to the default Adam, counts on the CPU). M1 ends within the
    train-step tolerances of the uninterrupted K = 1 run; the adversarial
    game's gap, from the other Adam rounding of one epoch, is printed."""
    from dvae_tpu_torch.train import checkpoint as ckpt

    cfg = LoopConfig(batch_size=128, end_epoch=4, seed=4)
    full, (_, hist) = _k_fit(kind, tmp_path / "full", cfg)
    for first, then in ((1, K_STEPS), (K_STEPS, 1)):
        d = tmp_path / f"{first}-{then}"
        _k_fit(kind, d, LoopConfig(**{**cfg.__dict__, "end_epoch": 3,
                                      "steps_per_dispatch": first}))
        saved = torch.load(next(d.glob("*_epoch_002_*.opt.pt")), weights_only=True)
        groups = [saved] if "param_groups" in saved else list(saved.values())
        assert all(g["capturable"] == (first > 1) for o in groups for g in o["param_groups"])
        resumed, (_, hist_r) = _k_fit(kind, d, LoopConfig(**{**cfg.__dict__, "start_epoch": 3,
                                                             "steps_per_dispatch": then}))
        gap = _fit_gap(resumed, full, hist_r, hist[2:])
        print(f"{kind} resume K={first} -> K={then} vs uninterrupted K=1: max weight diff "
              f"{gap[0]:.3e}, max metric rel diff {gap[1]:.3e}")
        if kind == "m1":
            _fits_agree(full, resumed, hist[2:], hist_r)
        assert all(np.isfinite(list(h["valid"].values())).all() for h in hist_r)
    assert ckpt.best_checkpoint(tmp_path / f"{K_STEPS}-1").exists()


@pytest.mark.cuda
def test_cuda_multistep_never_runs_eager_k_steps(cuda):
    """On the card K > 1 takes the graph or raises before any step runs:
    with a non-capturable Adam, a CPU generator or given noise."""
    from dvae_tpu_torch.train.steps import MultiStep, adam, make_train_step

    model = VAE(F, L, (128, 128)).cuda()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    xs = torch.rand((K_STEPS, 128, F), device=cuda) + 0.1
    opt = adam(model.parameters())
    with pytest.raises(ValueError, match="capturable"):
        MultiStep(make_train_step(model, opt, keep_grads=True), [opt])(
            xs, generator=torch.Generator(device=cuda))
    opt = adam(model.parameters(), capturable=True)
    multi = MultiStep(make_train_step(model, opt, keep_grads=True), [opt])
    with pytest.raises(ValueError, match="CUDA generator"):
        multi(xs, generator=torch.Generator())
    with pytest.raises(ValueError, match="sample_eps"):
        multi(xs, generator=torch.Generator(device=cuda),
              sample_eps=torch.zeros((K_STEPS, 128, L), device=cuda))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert not opt.state


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["vad_labels", "ibm_labels"])
def test_cuda_create_train_set_npz_matches_cpu(cuda, tmp_path, labels):
    """``create_train_set --format npz`` on the card (two utterances per
    launch: one launch per chunk) against the same CLI on the CPU: the rows
    at the spectrogram's tolerance, the statistics at rtol 1e-4, VAD labels
    exactly and IBM labels on all but 1e-4 of the bins."""
    from _ntcd_tree import make_raw_tree
    from dvae_tpu_torch.cli import create_train_set

    out = {}
    for platform in ("cuda", "cpu"):
        root = tmp_path / platform / "data"
        make_raw_tree(root / "subset" / "raw")
        before = stft_power.launches
        path = create_train_set.main(["--data-root", str(root), "--labels", labels,
                                      "--format", "npz", "--chunk-utterances", "2",
                                      "--platform", platform])
        assert stft_power.launches - before == (3 if platform == "cuda" else 0)
        with np.load(path) as f:
            out[platform] = {k: f[k] for k in f.files}
    got, want = out["cuda"], out["cpu"]
    assert set(got) == set(want)
    for split in ("train", "validation"):
        x, w = got[f"X_{split}"], want[f"X_{split}"]
        assert x.shape == w.shape
        assert float((np.abs(x - w) / (1e-4 * np.abs(w) + 1e-6 * w.max())).max()) <= 1.0
        if labels == "vad_labels":
            np.testing.assert_array_equal(got[f"Y_{split}"], want[f"Y_{split}"])
        else:
            assert (got[f"Y_{split}"] != want[f"Y_{split}"]).mean() <= 1e-4
    for k in ("X_train_mean", "X_train_std"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


@pytest.mark.cuda
def test_cuda_build_audio_train_set_matches_cpu(cuda, tmp_path):
    """``build_audio_train_set(fmt="npz")`` on the card (two utterances per
    launch: one launch per chunk of clean utterances and one per chunk of
    noisy train mixtures) against the same build on the CPU: the copies
    byte for byte, the VAD labels exactly, the noisy log-power statistics
    at rtol 5e-4 (the FFT and the plain matmul DFT round a frame's
    low-power bin each its own way; on the CPU the port and the JAX
    builder differ by as much)."""
    from _ntcd_tree import AUDIO_VIDEOS, RAW_UTTS, make_raw_tree, write_videos
    from dvae_tpu_torch.data.builders import NOISY_STATS, build_audio_train_set

    utts = dict(RAW_UTTS, test={("spk04", "sa1"): 12000, ("spk04", "sx5"): 17600})
    make_raw_tree(tmp_path / "raw", utts=utts, noisy=[("Babble", "-5"), ("LR", "-5")])
    files = {}
    for platform in ("cuda", "cpu"):
        out = tmp_path / platform
        write_videos(out, AUDIO_VIDEOS, "npz")
        before = stft_power.launches
        stats = build_audio_train_set(tmp_path / "raw", out, dataset_size="subset",
                                      fmt="npz", chunk=2, device=platform)
        # clean: 2 + 1 + 1 chunks of train, validation, test; noisy train: 6 / 2
        assert stft_power.launches - before == (7 if platform == "cuda" else 0)
        assert stats == out / f"{NOISY_STATS}.npz"
        files[platform] = {str(p.relative_to(out)): p for p in sorted(out.rglob("*"))
                           if p.is_file()}
    got, want = files["cuda"], files["cpu"]
    assert got.keys() == want.keys()
    for k, p in got.items():
        if k.endswith(".wav"):
            assert p.read_bytes() == want[k].read_bytes()
        elif k.endswith("_vad_labels_upsampled.npz"):
            with np.load(p) as a, np.load(want[k]) as b:
                np.testing.assert_array_equal(a["Y"], b["Y"])
    with np.load(got[f"{NOISY_STATS}.npz"]) as a, np.load(want[f"{NOISY_STATS}.npz"]) as b:
        for k in ("X_train_mean", "X_train_std"):
            np.testing.assert_allclose(a[k], b[k], rtol=5e-4)


@pytest.mark.cuda
def test_cuda_predict_batch_matches_plain(cuda):
    """A ``predict_vad_labels`` batch (``batch_utterances`` with
    ``StftConfig(center=True)``, one STFT power launch) on the card against
    the plain path on the CPU: the log power at 1e-3 absolute on the bins
    above 1e-6 of the peak power, labels and mask exactly; then one
    ``LSTMVad`` over both batches, the posteriors at atol 1e-3."""
    from dvae_tpu_torch.models import LSTMVad
    from dvae_tpu_torch.train.sequence import batch_utterances, make_lstm_vad_predict

    rng = np.random.default_rng(4)
    ds = []
    for n in (12000, 17600, 9600, 30000):
        t = np.arange(n) / 16000
        x = np.sin(2 * np.pi * 180 * t) * (t % 0.5 < 0.3) + 0.05 * rng.standard_normal(n)
        ds.append(((x / np.abs(x).max()).astype(np.float32),
                   (rng.uniform(size=(n // 256 + 1, 1)) > 0.5).astype(np.float32)))
    cfg = StftConfig(center=True)
    before = stft_power.launches
    xk, yk, mk = batch_utterances(ds, range(len(ds)), cfg, device=cuda)
    assert stft_power.launches - before == 1
    xp, yp, mp = batch_utterances(ds, range(len(ds)), cfg, device="cpu")
    assert torch.equal(yk.cpu(), yp) and torch.equal(mk.cpu(), mp)
    power = xp.exp()
    big = power > 1e-6 * power.amax()
    assert float((xk.cpu() - xp)[big].abs().max()) < 1e-3
    model = LSTMVad(513, 64, 2, generator=torch.Generator().manual_seed(0))
    pk = make_lstm_vad_predict(model.to(cuda))(xk).cpu()
    pp = make_lstm_vad_predict(model.cpu())(xp)
    np.testing.assert_allclose(pk.numpy(), pp.numpy(), atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["vad_labels", "ibm_labels"])
def test_cuda_build_video_matches_cpu(cuda, labels):
    """The video builder's per-utterance core on the card against the CPU:
    the IDCT-preprocessed, upsampled pixels within 1e-3 on the 0-255 scale;
    VAD labels exactly, with no STFT power launch; IBM labels through one
    launch, on all but 1e-4 of the bins (a bin within rounding of peak - 50
    dB may flip)."""
    from dvae_tpu_torch.data.builders import build_video

    rng = np.random.default_rng(6)
    decay = np.exp(-np.add.outer(np.arange(67), np.arange(67)) / 8.0).ravel()
    dct = rng.standard_normal((40, 67 * 67)) * decay * 300.0
    t = np.arange(21000) / 16000
    speech = np.sin(2 * np.pi * 170 * t) * (t % 0.4 < 0.25) + 0.01 * rng.standard_normal(len(t))
    before = stft_power.launches
    vk = build_video(dct, speech, labels, device=cuda)
    assert stft_power.launches - before == (labels == "ibm_labels")
    vp = build_video(dct, speech, labels, device="cpu")
    assert vk.x.shape == vp.x.shape and vk.x.shape[:2] == (67, 67)
    assert vk.x.shape[-1] == vk.y.shape[-1]
    np.testing.assert_allclose(vk.x, vp.x, rtol=0, atol=1e-3)
    if labels == "vad_labels":
        np.testing.assert_array_equal(vk.y, vp.y)
    else:
        assert float((vk.y != vp.y).mean()) <= 1e-4


@pytest.mark.cuda
def test_cuda_av_batch_and_models_match_cpu(cuda):
    """An AV batch (``batch_av_utterances``, one STFT power launch) on the
    card against the CPU's, then ``VideoVad`` and ``AVVad`` at full width
    (hidden 512, emb_dim 128, two layers; cuDNN convs and LSTM in f32)
    over both: the posteriors at atol 1e-4."""
    from dvae_tpu_torch.models import AVVad, VideoVad
    from dvae_tpu_torch.train.sequence import batch_av_utterances, make_lstm_vad_predict

    rng = np.random.default_rng(8)
    ds = []
    for n in (12000, 17600, 9600):
        t = np.arange(n) / 16000
        x = np.sin(2 * np.pi * 180 * t) * (t % 0.5 < 0.3) + 0.05 * rng.standard_normal(n)
        frames = n // 256 + 1
        ds.append(((x / np.abs(x).max()).astype(np.float32),
                   (255 * rng.random((frames - 2, 67, 67))).astype(np.float32),
                   (rng.uniform(size=(frames - 2, 1)) > 0.5).astype(np.float32)))
    cfg = StftConfig(center=True)
    before = stft_power.launches
    (sk, vk), yk, mk = batch_av_utterances(ds, range(len(ds)), cfg, device=cuda)
    assert stft_power.launches - before == 1
    (sp, vp), yp, mp = batch_av_utterances(ds, range(len(ds)), cfg, device="cpu")
    assert torch.equal(vk.cpu(), vp) and torch.equal(yk.cpu(), yp) and torch.equal(mk.cpu(), mp)
    big = sp.exp() > 1e-6 * sp.exp().amax()
    assert float((sk.cpu() - sp)[big].abs().max()) < 1e-3
    pixel = (np.float32([[120.0]]), np.float32([[60.0]]))
    audio = (sp.mean((0, 1)).numpy()[:, None], sp.std((0, 1)).numpy()[:, None] + 1.0)
    for model, xk, xp, norm in [(VideoVad(generator=torch.Generator().manual_seed(0)), vk, vp,
                                 pixel),
                                (AVVad(generator=torch.Generator().manual_seed(0)), (sp.to(cuda),
                                 vk), (sp, vp), (audio, pixel))]:
        pk = make_lstm_vad_predict(model.to(cuda), norm=norm)(xk).cpu()
        pp = make_lstm_vad_predict(model.cpu(), norm=norm)(xp)
        np.testing.assert_allclose(pk.numpy(), pp.numpy(), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_reconstruct_power_spec_takes_b2(cuda):
    """``eval/reconstruct`` on the card: ``power_spec`` takes one STFT power
    launch per signal (a ~5 s utterance, 313 frames) and its power is
    within 1e-4 of the CPU's plain power relative to each frame's peak; the
    figures' complex STFT is the matmul DFT, within 1e-5 of the CPU's
    relative to each frame's peak |S|. ``reconstruct`` and the classifiers
    of a full-width M2-info on the card, fed the same power, labels and
    injected noise as on the CPU: rtol 1e-4."""
    from dvae_tpu_torch.eval import reconstruct as rec

    rng = np.random.default_rng(9)
    t = np.arange(80800) / 16000  # 5.05 s
    wav = 0.3 * np.sin(2 * np.pi * 170 * t) * (t % 0.5 < 0.3) + 0.01 * rng.standard_normal(len(t))
    before = stft_power.launches
    S, x2 = rec.power_spec(wav, device=cuda)
    assert stft_power.launches - before == 1 and x2.is_cuda and x2.shape == (313, F)
    S_cpu, x2_cpu = rec.power_spec(wav)
    assert stft_power.launches - before == 1
    peak = x2_cpu.amax(-1, keepdim=True)
    assert float(((x2.cpu() - x2_cpu).abs() / peak).max()) <= 1e-4
    assert float((np.abs(S - S_cpu) / np.abs(S_cpu).max(-1, keepdims=True)).max()) <= 1e-5

    model = DisentangledVAE(F, 1, L, (128, 128))
    x2_host = x2.cpu()
    y = (rng.random((313, 1)) > 0.4).astype(np.float32)
    eps = rng.standard_normal((313, L)).astype(np.float32)
    r_cpu, z_cpu = rec.reconstruct(model, x2_host, y, eps=eps, return_z=True)
    soft_cpu = rec.classify(model, "classify_from_x", x2_host)
    aux_cpu = rec.classify(model, "classify_from_z", z_cpu)
    model.to(cuda)
    r, z = rec.reconstruct(model, x2, y, eps=eps, return_z=True)
    np.testing.assert_allclose(r, r_cpu, rtol=1e-4)
    np.testing.assert_allclose(z, z_cpu, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rec.classify(model, "classify_from_x", x2), soft_cpu,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rec.classify(model, "classify_from_z", z), aux_cpu,
                               rtol=1e-4, atol=1e-6)

"""The port's CUDA kernel against its plain PyTorch version, on the card.

Imports nothing of JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Every test skips without a CUDA device (the kernel has no CPU mode).
Tolerances: a frozen chain (var_rw = 0) is the same decoder arithmetic in
another summation order, rtol 1e-5. A live chain fed the same noise may
flip an acceptance where ``log u`` lies within rounding of ``E - E'``, so
at least 99% of rows must end at the same z, and those rows' samples agree
to rtol 1e-4.
"""

import pytest
import torch

from dvae_tpu_torch.enhance import mh_chain
from dvae_tpu_torch.enhance.mcem import McemConfig, run_mcem
from dvae_tpu_torch.enhance.mh_chain import (
    extract_decoder_mlp,
    make_chain_noise,
    mh_chain_reference,
    run_mh_chain,
)
from dvae_tpu_torch.models import VAE

F, L = 513, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _problem(dev, rows, h_dim=(128, 128), seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tm = VAE(F, L, h_dim).to(dev)
    x2 = torch.rand((rows, F), generator=gen, device=dev) + 0.05
    vb = torch.rand((rows, F), generator=gen, device=dev) + 0.05
    g = torch.rand((rows,), generator=gen, device=dev) + 0.5
    z0 = 0.1 * torch.randn((rows, L), generator=gen, device=dev)
    return extract_decoder_mlp(tm, L), x2, vb, g, z0, gen


@pytest.mark.cuda
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_frozen_chain_matches_plain(cuda, wf_mode):
    mats, x2, vb, g, z0, gen = _problem(cuda, 1000)  # not a tile multiple
    noise = make_chain_noise(5, 1000, L, gen, cuda)
    before = mh_chain.launches
    out = run_mh_chain(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0, wf_mode)
    torch.cuda.synchronize()
    assert mh_chain.launches == before + 1
    ref = mh_chain_reference(mats, x2, vb, g, z0, None, noise, 2, 3, 0.0, wf_mode)
    assert torch.equal(out[0], z0)
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [(128, 128), (128, 64)], ids=["square", "nonsquare"])
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_live_chain_matches_plain(cuda, h_dim, wf_mode):
    mats, x2, vb, g, z0, gen = _problem(cuda, 4096, h_dim, seed=1)
    noise = make_chain_noise(8, 4096, L, gen, cuda)
    zk, *ok = run_mh_chain(mats, x2, vb, g, z0, None, noise, 4, 4, 0.01, wf_mode)
    zr, *orf = mh_chain_reference(mats, x2, vb, g, z0, None, noise, 4, 4, 0.01, wf_mode)
    same = (zk - zr).abs().amax(-1) < 1e-4
    assert same.float().mean() > 0.99
    assert (zk != z0).any(-1).float().mean() > 0.5  # the chain explores
    for a, b in zip(ok, orf):
        torch.testing.assert_close(a[..., same, :], b[..., same, :], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_conditioned_bias_and_mismatch(cuda):
    mats, x2, vb, g, z0, gen = _problem(cuda, 512, seed=2)
    w1y = 0.3 * torch.randn((2, mats[0].shape[1]), generator=gen, device=cuda)
    cmats = (mats[0], w1y, *mats[2:])
    y = (torch.rand((512, 2), generator=gen, device=cuda) > 0.5).float()
    noise = make_chain_noise(1, 512, L, gen, cuda)
    _, sk = run_mh_chain(cmats, x2, vb, g, z0, y, noise, 0, 1, 0.0)
    _, sr = mh_chain_reference(cmats, x2, vb, g, z0, y, noise, 0, 1, 0.0)
    torch.testing.assert_close(sk, sr, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="conditioning mismatch"):
        run_mh_chain(cmats, x2, vb, g, z0, None, noise, 0, 1, 0.0)
    with pytest.raises(ValueError, match="conditioning mismatch"):
        run_mh_chain(mats, x2, vb, g, z0, y, noise, 0, 1, 0.0)


@pytest.mark.cuda
def test_cuda_run_mcem_frozen_matches_plain(cuda, monkeypatch):
    """run_mcem through the kernel vs through the plain chain on the card."""
    b, n = 4, 64
    mats, x2, _, _, z0, _ = _problem(cuda, b * n, seed=3)
    x2, z0 = x2.reshape(b, n, F), z0.reshape(b, n, L)
    mask = torch.ones((b, n), device=cuda)
    mask[1, 40:] = 0.0
    cfg = McemConfig(niter=5, nsamples_e_step=3, burnin_e_step=2, nsamples_wf=4,
                     burnin_wf=2, var_rw=0.0)
    before = mh_chain.launches
    rk = run_mcem(mats, x2, z0, mask, 7, cfg)
    assert mh_chain.launches == before + cfg.niter + 1
    from dvae_tpu_torch.enhance import mcem

    monkeypatch.setattr(mcem, "run_mh_chain", mh_chain_reference)
    rp = run_mcem(mats, x2, z0, mask, 7, cfg)
    assert mh_chain.launches == before + cfg.niter + 1
    for a, b_ in zip(rk, rp):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5)

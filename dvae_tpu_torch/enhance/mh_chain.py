"""The MCEM Metropolis-Hastings chain: CUDA kernel wrapper and plain version
(port of ``dvae_tpu.enhance.pallas_mcem``).

:func:`run_mh_chain` runs one chain segment (burn-in + samples) over
independent flattened (rows, F) frame rows. On CUDA tensors it launches the
hand-written kernel ``csrc/mh_chain.cu`` (built with ``nvcc`` at first use);
on CPU tensors it runs :func:`mh_chain_reference`, the same chain written as
a step loop on tensors. There is no fallback between the two.

Per step: ``z' = z + sqrt(var_rw) eps``; ``Vs' = dec(z')``;
``E' = sum_f [log Vx' + x2/Vx'] + ||z'||^2/2`` with
``Vx' = max(g Vs' + Vb, VX_FLOOR)``; accept iff ``log u < E - E'``.
E-step mode returns the accepted Vs of every post-burn-in step; WF mode the
sums of ``g Vs / Vx`` and ``Vb / Vx`` over those steps.

The chain's randomness is an input, ``noise`` of shape
``(n_steps, rows, L + 1)``: L standard normals, then one ``log u`` with
``u ~ U[1e-38, 1)``. :func:`make_chain_noise` draws it for the main path.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dvae_tpu_torch.build import load_library
from dvae_tpu_torch.enhance.nmf import VX_FLOOR

# dynamic shared memory one H100 block may use
_MAX_SMEM = 232448

# kernel launches since the last reset (only the launch in run_mh_chain counts)
launches = 0


def extract_decoder_mlp(model, z_dim: int):
    """The decoder's dense weights as ``(w1z, w1y, b1, w2, b2, w3, b3)``,
    each (in, out) f32 and contiguous; ``w1y`` is the conditioning block of
    the first layer (None for M1). None when the decoder is not the
    two-hidden-layer MLP the kernel supports."""
    dec = model.decoder
    if len(dec.hidden) != 2:
        return None
    l1, l2 = dec.hidden
    w1 = l1.weight.detach().t().float()
    if w1.shape[0] < z_dim:
        return None
    w1z = w1[:z_dim].contiguous()
    w1y = w1[z_dim:].contiguous() if w1.shape[0] > z_dim else None

    def c(t):
        return t.detach().float().contiguous()

    return (w1z, w1y, c(l1.bias), c(l2.weight.t()), c(l2.bias),
            c(dec.reconstruction.weight.t()), c(dec.reconstruction.bias))


def make_chain_noise(n_steps: int, rows: int, l: int, generator: torch.Generator,
                     device) -> torch.Tensor:
    """(n_steps, rows, L+1) chain noise on ``device``: L proposal normals,
    then the acceptance log-uniform drawn on [1e-38, 1)."""
    eps = torch.randn((n_steps, rows, l), generator=generator, device=device)
    u = torch.rand((n_steps, rows, 1), generator=generator, device=device)
    return torch.cat([eps, torch.log(u.clamp_min_(1e-38))], dim=-1)


def _fold_bias(mats, y, rows):
    """The conditioning folded into a first-layer row bias ``b1 + y @ w1y``
    (``None`` rows => the plain bias, shared by every row)."""
    w1z, w1y, b1 = mats[:3]
    if (y is None) != (w1y is None):
        raise ValueError(
            "conditioning mismatch: y is "
            f"{'None' if y is None else 'given'} but the decoder mats "
            f"{'have' if w1y is not None else 'lack'} a conditioning block")
    if y is None:
        return b1
    if y.shape[0] != rows:
        raise ValueError(f"y has {y.shape[0]} rows, expected {rows}")
    return (b1 + y.float() @ w1y).contiguous()


def _check(x2, vb, g, z, noise, mats, n_burn, n_samples):
    rows, f = x2.shape
    l = z.shape[-1]
    w1z, _, b1, w2, b2, w3, b3 = mats
    h1, h2 = w1z.shape[1], w2.shape[1]
    want = {
        "x2": (x2, (rows, f)), "vb": (vb, (rows, f)), "g": (g, (rows,)),
        "z": (z, (rows, l)), "noise": (noise, (n_burn + n_samples, rows, l + 1)),
        "w1z": (w1z, (l, h1)), "b1": (b1, (h1,)), "w2": (w2, (h1, h2)),
        "b2": (b2, (h2,)), "w3": (w3, (h2, f)), "b3": (b3, (f,)),
    }
    dev = x2.device
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x2 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows < 1 or n_burn < 0 or n_samples < 1:
        raise ValueError(
            f"bad chain shape rows={rows} n_burn={n_burn} n_samples={n_samples}")


def mh_chain_reference(mats, x2, vb, g, z, y, noise, n_burn: int, n_samples: int,
                       var_rw: float, wf_mode: bool = False):
    """Plain PyTorch chain: the same contract as :func:`run_mh_chain`,
    written as a step loop on tensors (any device)."""
    _check(x2, vb, g, z, noise, mats, n_burn, n_samples)
    by = _fold_bias(mats, y, x2.shape[0])
    w1z, _, _, w2, b2, w3, b3 = mats
    l = z.shape[-1]
    sqrt_var = math.sqrt(var_rw)
    gg = g[:, None]

    def dec(z):
        h = torch.tanh(z @ w1z + by)
        h = torch.tanh(h @ w2 + b2)
        return torch.exp(h @ w3 + b3)

    def energy(z, vs):
        vx = (gg * vs + vb).clamp_min(VX_FLOOR)
        return (torch.log(vx) + x2 / vx).sum(-1) + 0.5 * (z * z).sum(-1)

    vs = dec(z)
    e = energy(z, vs)
    samples = []
    wfs = torch.zeros_like(x2)
    wfn = torch.zeros_like(x2)
    for k in range(n_burn + n_samples):
        eps, log_u = noise[k, :, :l], noise[k, :, l]
        zp = z + sqrt_var * eps
        vsp = dec(zp)
        ep = energy(zp, vsp)
        acc = log_u < (e - ep)
        z = torch.where(acc[:, None], zp, z)
        vs = torch.where(acc[:, None], vsp, vs)
        e = torch.where(acc, ep, e)
        if k >= n_burn:
            if wf_mode:
                vsc = gg * vs
                vx = (vsc + vb).clamp_min(VX_FLOOR)
                wfs = wfs + vsc / vx
                wfn = wfn + vb / vx
            else:
                samples.append(vs)
    if wf_mode:
        return z, wfs, wfn
    return z, torch.stack(samples)


@functools.cache
def build_library() -> ctypes.CDLL:
    """Compile ``csrc/mh_chain.cu`` for sm_90a into ``build/`` (once per
    source version), load it and declare its C interface (once per
    process)."""
    lib = load_library("mh_chain.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mh_chain_launch.argtypes = [p] * 15 + [i] * 9 + [ctypes.c_float, p]
    lib.mh_chain_launch.restype = i
    lib.mh_chain_smem_bytes.argtypes = [i] * 5
    lib.mh_chain_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _check_smem(f: int, l: int, h1: int, h2: int, wf_mode: bool) -> None:
    """Raise unless one block's shared memory holds these widths (checked
    once each)."""
    smem = build_library().mh_chain_smem_bytes(f, l, h1, h2, int(wf_mode))
    if smem > _MAX_SMEM:
        raise ValueError(f"widths need {smem} B of shared memory per block "
                         f"(> {_MAX_SMEM}): F={f} L={l} H=({h1}, {h2})")


def _launch(mats, x2, vb, g, z, by, noise, n_burn, n_samples, var_rw, wf_mode):
    global launches
    rows, f = x2.shape
    l = z.shape[-1]
    w1z, _, _, w2, b2, w3, b3 = mats
    h1, h2 = w1z.shape[1], w2.shape[1]
    # layers 1 and 2 read 2 weight columns at a time as one 8-byte load
    if h1 % 2 or h2 % 2 or w1z.data_ptr() % 8 or w2.data_ptr() % 8:
        raise ValueError(f"the kernel needs even hidden widths and 8-byte aligned "
                         f"w1z/w2, got H=({h1}, {h2})")
    _check_smem(f, l, h1, h2, wf_mode)
    lib = build_library()
    z_out = torch.empty((rows, l), device=x2.device)
    if wf_mode:
        outs = (torch.empty((rows, f), device=x2.device),
                torch.empty((rows, f), device=x2.device))
        samples_p, wfs_p, wfn_p = None, outs[0].data_ptr(), outs[1].data_ptr()
    else:
        outs = (torch.empty((n_samples, rows, f), device=x2.device),)
        samples_p, wfs_p, wfn_p = outs[0].data_ptr(), None, None
    by_stride = h1 if by.dim() == 2 else 0
    with torch.cuda.device(x2.device):
        err = lib.mh_chain_launch(
            x2.data_ptr(), vb.data_ptr(), g.data_ptr(), z.data_ptr(), by.data_ptr(),
            noise.data_ptr(), w1z.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), z_out.data_ptr(), samples_p, wfs_p, wfn_p,
            rows, f, l, h1, h2, n_burn + n_samples, n_burn, by_stride, int(wf_mode),
            math.sqrt(var_rw), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mh_chain kernel launch failed: cudaError {err}")
    launches += 1
    return (z_out, *outs)


def run_mh_chain(mats, x2, vb, g, z, y, noise, n_burn: int, n_samples: int,
                 var_rw: float, wf_mode: bool = False):
    """Run one MH chain segment on a flattened (rows, F) frame batch.

    Args:
        mats: decoder weights from :func:`extract_decoder_mlp`.
        x2, vb: (rows, F) mixture power / NMF noise variance.
        g: (rows,) gains; z: (rows, L) current latents.
        y: optional (rows, Y) conditioning labels, folded into the first
            layer's bias.
        noise: (n_burn + n_samples, rows, L + 1), see :func:`make_chain_noise`.
    Returns:
        E-step mode: ``(z_final (rows, L), vs_samples (n_samples, rows, F))``.
        WF mode: ``(z_final, wfs_sum (rows, F), wfn_sum (rows, F))``.
    """
    _check(x2, vb, g, z, noise, mats, n_burn, n_samples)
    if x2.device.type == "cpu":
        return mh_chain_reference(mats, x2, vb, g, z, y, noise, n_burn, n_samples,
                                  var_rw, wf_mode)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    by = _fold_bias(mats, y, x2.shape[0])
    return _launch(mats, x2, vb, g, z, by, noise, n_burn, n_samples, var_rw, wf_mode)

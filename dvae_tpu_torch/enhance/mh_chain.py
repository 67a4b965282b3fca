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

``fast_decoder`` selects the decoder's precision on both paths. False: its
three products in f32 (the kernel's f32 body). True: as the JAX package's
``make_mlp_decoder(fast=True)``, each product rounds both operands to bf16
and sums in f32 (the kernel's tensor-core body, which reads the weights
packed by :func:`pack_decoder_mma`); biases, tanh, exp and the energy stay
f32.
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

# kernel launches since the last reset (only the launch in run_mh_chain
# counts): all of them, and those of the bf16 tensor-core body
launches = 0
launches_mma = 0


def _find_decoder(module):
    """The first submodule named ``decoder``: this level first, then each
    child's subtree in order (``model.decoder``, or
    ``model.enc_dec_clf.decoder`` for the disentangled VAE)."""
    children = dict(module.named_children())
    if "decoder" in children:
        return children["decoder"]
    for child in children.values():
        hit = _find_decoder(child)
        if hit is not None:
            return hit
    return None


def extract_decoder_mlp(model, z_dim: int):
    """The decoder's dense weights as ``(w1z, w1y, b1, w2, b2, w3, b3)``,
    each (in, out) f32 and contiguous; ``w1y`` is the conditioning block of
    the first layer (None for M1). None when the model has no decoder or
    it is not the two-hidden-layer MLP the kernel supports."""
    dec = _find_decoder(model)
    if dec is None or len(getattr(dec, "hidden", ())) != 2:
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


def _bf16(t):
    """``t`` rounded to bf16 (to nearest even), as f32."""
    return t.to(torch.bfloat16).float()


def _fold_bias(mats, y, rows, fast_decoder=False):
    """The conditioning folded into a first-layer row bias ``b1 + y @ w1y``
    (``None`` rows => the plain bias, shared by every row). With
    ``fast_decoder`` both operands of the product are rounded to bf16, as
    the JAX package multiplies ``[z, y]`` by ``[w1z; w1y]`` in bf16."""
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
    if fast_decoder:
        return (b1 + _bf16(y.float()) @ _bf16(w1y)).contiguous()
    return (b1 + y.float() @ w1y).contiguous()


def fold_conditioning(mats, y, fast_decoder: bool = False):
    """``mats`` with the conditioning ``y`` (rows, Y) folded into a
    per-row first-layer bias (rows, H1) by :func:`_fold_bias`, and no
    conditioning block left: a chain run on the result needs no ``y``.
    MCEM folds once per run, since its labels are fixed for the run.
    ``y=None`` returns ``mats`` after the mismatch check."""
    if y is None:
        _fold_bias(mats, None, 0)
        return mats
    by = _fold_bias(mats, y, y.shape[0], fast_decoder)
    return (mats[0], None, by, *mats[3:])


def _check(x2, vb, g, z, noise, mats, n_burn, n_samples):
    rows, f = x2.shape
    l = z.shape[-1]
    w1z, _, b1, w2, b2, w3, b3 = mats
    h1, h2 = w1z.shape[1], w2.shape[1]
    want = {
        "x2": (x2, (rows, f)), "vb": (vb, (rows, f)), "g": (g, (rows,)),
        "z": (z, (rows, l)), "noise": (noise, (n_burn + n_samples, rows, l + 1)),
        # b1 is shared by every row, or a row bias from fold_conditioning
        "w1z": (w1z, (l, h1)), "b1": (b1, (rows, h1) if b1.dim() == 2 else (h1,)),
        "w2": (w2, (h1, h2)), "b2": (b2, (h2,)), "w3": (w3, (h2, f)), "b3": (b3, (f,)),
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


def decoder_reference(mats, by, fast_decoder: bool = False):
    """The plain decoder ``z -> Vs`` of the chain, with the first layer's
    (row) bias ``by`` from :func:`_fold_bias`: the counterpart of the JAX
    package's ``make_mlp_decoder(mats, fast)``. Differentiable in ``z``:
    with ``fast_decoder`` its bf16 casts round the cotangents to bf16 in
    the backward pass, as the transpose of JAX's casts does."""
    w1z, _, _, w2, b2, w3, b3 = mats
    if fast_decoder:
        w1z, w2, w3 = _bf16(w1z), _bf16(w2), _bf16(w3)
        rnd = _bf16
    else:
        def rnd(a):
            return a

    def dec(z):
        h = torch.tanh(rnd(z) @ w1z + by)
        h = torch.tanh(rnd(h) @ w2 + b2)
        return torch.exp(rnd(h) @ w3 + b3)

    return dec


def mh_chain_reference(mats, x2, vb, g, z, y, noise, n_burn: int, n_samples: int,
                       var_rw: float, wf_mode: bool = False, fast_decoder: bool = False):
    """Plain PyTorch chain: the same contract as :func:`run_mh_chain`,
    written as a step loop on tensors (any device)."""
    _check(x2, vb, g, z, noise, mats, n_burn, n_samples)
    dec = decoder_reference(mats, _fold_bias(mats, y, x2.shape[0], fast_decoder),
                            fast_decoder)
    l = z.shape[-1]
    sqrt_var = math.sqrt(var_rw)
    gg = g[:, None]

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
    for launch in (lib.mh_chain_launch, lib.mh_chain_mma_launch):
        launch.argtypes = [p] * 15 + [i] * 9 + [ctypes.c_float, p]
        launch.restype = i
    lib.mh_chain_smem_bytes.argtypes = [i] * 6
    lib.mh_chain_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _check_smem(f: int, l: int, h1: int, h2: int, wf_mode: bool, mma: bool) -> None:
    """Raise unless one block's shared memory holds these widths (checked
    once each)."""
    smem = build_library().mh_chain_smem_bytes(f, l, h1, h2, int(wf_mode), int(mma))
    if smem > _MAX_SMEM:
        raise ValueError(f"widths need {smem} B of shared memory per block "
                         f"(> {_MAX_SMEM}): F={f} L={l} H=({h1}, {h2})")


def pack_mma_weight(w: torch.Tensor, n_multiple: int) -> torch.Tensor:
    """A (K, N) weight in bf16, in the B-fragment order of
    ``mma.m16n8k16``: zero-padded to K16 (a multiple of 16) rows and to a
    multiple of ``n_multiple`` columns, then laid out (K16 / 16 k-steps,
    N / 8 n-tiles, 32 lanes, 4). Lane ``4 g + t`` of n-tile ``nt`` holds
    column ``8 nt + g`` at rows ``2t, 2t + 1`` (register b0) and ``2t + 8,
    2t + 9`` (b1) of its k-step, the lower row in the lower half."""
    k, n = w.shape
    kp, np_ = -(-k // 16) * 16, -(-n // n_multiple) * n_multiple
    wp = torch.zeros((kp, np_), dtype=torch.float32, device=w.device)
    wp[:k, :n] = w
    # row 16 ks + 8 kh + 2 t + e0, column 8 nt + g -> [ks, nt, g, t, kh, e0]
    wp = wp.to(torch.bfloat16).reshape(kp // 16, 2, 4, 2, np_ // 8, 8)
    return wp.permute(0, 4, 5, 2, 1, 3).reshape(kp // 16, np_ // 8, 32, 4).contiguous()


def _pad(v: torch.Tensor, multiple: int) -> torch.Tensor:
    n = v.shape[0]
    return torch.nn.functional.pad(v, (0, -n % multiple)).contiguous()


def pack_decoder_mma(mats):
    """The decoder as the kernel's bf16 body reads it: ``(w1p, w2p, w3p,
    b2p, b3p)``. L, H1 and H2 are padded to multiples of 16 and F to a
    multiple of 8 with zero weights and zero biases; a padded hidden unit
    is tanh(0) = 0 and meets zero rows in the next layer, so the padding
    changes nothing. The first layer's bias is the row bias ``by``, which
    the kernel pads itself."""
    w1z, _, _, w2, b2, w3, b3 = mats
    return (pack_mma_weight(w1z, 16), pack_mma_weight(w2, 16), pack_mma_weight(w3, 8),
            _pad(b2, 16), _pad(b3, 8))


# packs of the last few decoders, each kept with its source tensors so that
# their storage (and so their data_ptr) cannot be reused while cached
_PACKS: dict = {}
_PACKS_KEPT = 4


def _packed(mats):
    """:func:`pack_decoder_mma` of ``mats``, cached on the tensors' address,
    version counter and shape: the launches of one enhanced batch pack once,
    and new or updated weights pack anew."""
    w1z, _, _, w2, b2, w3, b3 = mats
    src = (w1z, w2, b2, w3, b3)
    key = tuple((t.data_ptr(), t._version, tuple(t.shape)) for t in src)
    hit = _PACKS.get(key)
    if hit is None:
        if len(_PACKS) >= _PACKS_KEPT:
            del _PACKS[next(iter(_PACKS))]
        hit = _PACKS[key] = (src, pack_decoder_mma(mats))
    return hit[1]


def _launch(mats, x2, vb, g, z, by, noise, n_burn, n_samples, var_rw, wf_mode,
            fast_decoder):
    global launches, launches_mma
    rows, f = x2.shape
    l = z.shape[-1]
    w1z, _, _, w2, b2, w3, b3 = mats
    h1, h2 = w1z.shape[1], w2.shape[1]
    # the f32 body's layers 1 and 2 read 2 weight columns at a time as one
    # 8-byte load
    if not fast_decoder and (h1 % 2 or h2 % 2 or w1z.data_ptr() % 8 or w2.data_ptr() % 8):
        raise ValueError(f"the kernel needs even hidden widths and 8-byte aligned "
                         f"w1z/w2, got H=({h1}, {h2})")
    _check_smem(f, l, h1, h2, wf_mode, fast_decoder)
    lib = build_library()
    if fast_decoder:
        launch = lib.mh_chain_mma_launch
        w1p, w2p, w3p, b2, b3 = _packed(mats)
        weights = (w1p.data_ptr(), w2p.data_ptr(), b2.data_ptr(), w3p.data_ptr(),
                   b3.data_ptr())
    else:
        launch = lib.mh_chain_launch
        weights = (w1z.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                   b3.data_ptr())
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
        err = launch(
            x2.data_ptr(), vb.data_ptr(), g.data_ptr(), z.data_ptr(), by.data_ptr(),
            noise.data_ptr(), *weights, z_out.data_ptr(), samples_p, wfs_p, wfn_p,
            rows, f, l, h1, h2, n_burn + n_samples, n_burn, by_stride, int(wf_mode),
            math.sqrt(var_rw), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mh_chain kernel launch failed: cudaError {err}")
    launches += 1
    launches_mma += fast_decoder
    return (z_out, *outs)


def run_mh_chain(mats, x2, vb, g, z, y, noise, n_burn: int, n_samples: int,
                 var_rw: float, wf_mode: bool = False, fast_decoder: bool = False):
    """Run one MH chain segment on a flattened (rows, F) frame batch.

    Args:
        mats: decoder weights from :func:`extract_decoder_mlp`.
        x2, vb: (rows, F) mixture power / NMF noise variance.
        g: (rows,) gains; z: (rows, L) current latents.
        y: optional (rows, Y) conditioning labels, folded into the first
            layer's bias.
        noise: (n_burn + n_samples, rows, L + 1), see :func:`make_chain_noise`.
        fast_decoder: bf16 products with f32 sums (the tensor-core body) if
            True, f32 products if False.
    Returns:
        E-step mode: ``(z_final (rows, L), vs_samples (n_samples, rows, F))``.
        WF mode: ``(z_final, wfs_sum (rows, F), wfn_sum (rows, F))``.
    """
    _check(x2, vb, g, z, noise, mats, n_burn, n_samples)
    if x2.device.type == "cpu":
        return mh_chain_reference(mats, x2, vb, g, z, y, noise, n_burn, n_samples,
                                  var_rw, wf_mode, fast_decoder)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    by = _fold_bias(mats, y, x2.shape[0], fast_decoder)
    return _launch(mats, x2, vb, g, z, by, noise, n_burn, n_samples, var_rw, wf_mode,
                   fast_decoder)

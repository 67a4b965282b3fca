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

``fast_stats`` (``McemConfig.fast_stats``) keeps the planes the chain reads
and writes in HBM as bf16, as the JAX package's scan engine does; the
arithmetic stays f32. The caller rounds the planes once and passes them at
their storage dtype, and both paths take the same planes: ``x2`` bf16,
``vb`` bf16 in E-step mode and f32 in WF mode, where the mask sums need
the f32 Vb (so ``WFs + WFn = 1`` stays exact) and the energy rounds it to
bf16 itself. E-step mode then emits ``bf16(Vs)`` of the accepted state;
the chain's own Vs stays f32.

The chain's randomness is an input, ``noise`` of shape
``(n_steps, rows, L + 1)``: L standard normals, then one ``log u`` with
``u ~ U[1e-38, 1)``. :func:`make_chain_noise` draws it for the main path.

The decoder is any tanh MLP: any number of hidden layers (none too) of any
width (:class:`DecoderMats`). ``fast_decoder`` selects its precision on
both paths. False: its products in f32 (the kernel's f32 body, any depth).
True, at depth 2 only: as the JAX package's
``make_mlp_decoder(fast=True)``, each product rounds both operands to bf16
and sums in f32 (the kernel's tensor-core body, which reads the weights
packed by :func:`pack_decoder_mma`); biases, tanh, exp and the energy stay
f32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dvae_tpu_torch.build import load_library
from dvae_tpu_torch.enhance.nmf import VX_FLOOR

# dynamic shared memory one H100 block may use
_MAX_SMEM = 232448
# hidden layers the kernel carries in its arguments (its MAX_HIDDEN); other
# depths, 0 too, run the instantiation that reads a table in device memory
_ARGS_DEPTH = 8
# frame rows of one block's tile (the kernel's TR)
_TILE_ROWS = 16
#: the kernel's layouts, in the order the wrapper tries them (see
#: ``csrc/mh_chain.cu``): the bf16 body's E-step segments on bf16 planes
#: with the packed decoder in shared memory and the planes in registers;
#: then the WF sums and the row bias in shared memory, then in global
#: memory, then the hidden activations too
LAYOUTS = ("resident", "shared", "lean", "wide")

# kernel launches since the last reset (only the launch in run_mh_chain
# counts): all of them, those of the bf16 tensor-core body, and those in
# the resident layout
launches = 0
launches_mma = 0
launches_resident = 0


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


class DecoderMats(NamedTuple):
    """A decoder's dense weights, each (in, out) f32 and contiguous: the
    first layer split into its latent and conditioning blocks, then each
    further hidden layer, then the output layer. With no hidden layer the
    first layer is the output layer itself (``w1z`` (L, F), ``b1`` (F,) or
    a (rows, F) row bias, ``w_out`` and ``b_out`` None)."""

    w1z: torch.Tensor         # (L, H1)
    w1y: torch.Tensor | None  # (Y, H1), None for an unconditioned decoder
    b1: torch.Tensor          # (H1,), or a (rows, H1) row bias from fold_conditioning
    hidden: tuple             # ((w (H_{i-1}, H_i), b (H_i,)), ...) for layers 2..D
    w_out: torch.Tensor | None  # (H_D, F); None with no hidden layer
    b_out: torch.Tensor | None  # (F,); None with no hidden layer

    @property
    def widths(self) -> tuple:
        """The hidden widths (H1, ..., H_D); () with no hidden layer."""
        if self.w_out is None:
            return ()
        return (self.w1z.shape[1], *(w.shape[1] for w, _ in self.hidden))

    def map(self, fn) -> "DecoderMats":
        """The same layout with ``fn`` applied to every tensor."""
        def opt(t):
            return None if t is None else fn(t)

        return DecoderMats(fn(self.w1z), opt(self.w1y), fn(self.b1),
                           tuple((fn(w), fn(b)) for w, b in self.hidden), opt(self.w_out),
                           opt(self.b_out))


def decoder_widths(model):
    """The hidden widths of the model's decoder, None when it has none.
    Reads shapes only, so it does no device work."""
    dec = _find_decoder(model)
    if dec is None:
        return None
    return tuple(layer.out_features for layer in getattr(dec, "hidden", ()))


def extract_decoder_mlp(model, z_dim: int):
    """The decoder's weights as :class:`DecoderMats` (``w1y`` None for
    M1), or None when the model has no decoder."""
    dec = _find_decoder(model)
    if dec is None:
        return None

    def c(t):
        return t.detach().float().contiguous()

    first, *rest = (*getattr(dec, "hidden", ()), dec.reconstruction)
    w1 = first.weight.detach().t().float()
    if w1.shape[0] < z_dim:
        raise ValueError(f"the decoder's first layer takes {w1.shape[0]} inputs, "
                         f"fewer than z_dim={z_dim}")
    w1z = w1[:z_dim].contiguous()
    w1y = w1[z_dim:].contiguous() if w1.shape[0] > z_dim else None
    out = (c(rest[-1].weight.t()), c(rest[-1].bias)) if rest else (None, None)
    return DecoderMats(w1z, w1y, c(first.bias),
                       tuple((c(m.weight.t()), c(m.bias)) for m in rest[:-1]), *out)


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
    (the output layer's, with no hidden layer); ``y`` None gives the plain
    bias, shared by every row. With
    ``fast_decoder`` both operands of the product are rounded to bf16, as
    the JAX package multiplies ``[z, y]`` by ``[w1z; w1y]`` in bf16."""
    w1y, b1 = mats.w1y, mats.b1
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
    per-row first-layer bias (rows, H1), or (rows, F) with no hidden layer,
    by :func:`_fold_bias`, and no
    conditioning block left: a chain run on the result needs no ``y``.
    MCEM folds once per run, since its labels are fixed for the run.
    ``y=None`` returns ``mats`` after the mismatch check."""
    if y is None:
        _fold_bias(mats, None, 0)
        return mats
    return mats._replace(w1y=None, b1=_fold_bias(mats, y, y.shape[0], fast_decoder))


def plane_dtypes(fast_stats: bool, wf_mode: bool) -> tuple:
    """The dtypes of the ``x2`` and ``vb`` planes a chain segment takes
    (see the module docstring)."""
    half = torch.bfloat16 if fast_stats else torch.float32
    return half, torch.float32 if wf_mode else half


def _check(x2, vb, g, z, noise, mats, n_burn, n_samples, fast_decoder, fast_stats=False,
           wf_mode=False):
    rows, f = x2.shape
    l = z.shape[-1]
    widths = mats.widths
    if fast_decoder and len(widths) != 2:
        raise ValueError(f"the bf16 body serves two hidden layers, not {len(widths)}: "
                         "other depths run in f32")
    n1 = widths[0] if widths else f  # the first layer's outputs
    want = {
        "x2": (x2, (rows, f)), "vb": (vb, (rows, f)), "g": (g, (rows,)),
        "z": (z, (rows, l)), "noise": (noise, (n_burn + n_samples, rows, l + 1)),
        # b1 is shared by every row, or a row bias from fold_conditioning
        "w1z": (mats.w1z, (l, n1)),
        "b1": (mats.b1, (rows, n1) if mats.b1.dim() == 2 else (n1,)),
    }
    if widths:
        want.update(w_out=(mats.w_out, (widths[-1], f)), b_out=(mats.b_out, (f,)))
    for i, (w, b) in enumerate(mats.hidden):
        want[f"hidden[{i}].w"] = (w, (widths[i], widths[i + 1]))
        want[f"hidden[{i}].b"] = (b, (widths[i + 1],))
    dev = x2.device
    dtypes = dict(zip(("x2", "vb"), plane_dtypes(fast_stats, wf_mode)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        dtype = dtypes.get(name, torch.float32)
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {str(dtype).removeprefix('torch.')} at "
                            f"fast_stats={fast_stats}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x2 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows < 1 or n_burn < 0 or n_samples < 1:
        raise ValueError(
            f"bad chain shape rows={rows} n_burn={n_burn} n_samples={n_samples}")


def decoder_reference(mats, by, fast_decoder: bool = False):
    """The plain decoder ``z -> Vs`` of the chain, with the first layer's
    (row) bias ``by`` from :func:`_fold_bias` (with no hidden layer, the
    output layer's): the counterpart of the JAX
    package's ``make_mlp_decoder(mats, fast)``. Differentiable in ``z``:
    with ``fast_decoder`` its bf16 casts round the cotangents to bf16 in
    the backward pass, as the transpose of JAX's casts does."""
    if fast_decoder:
        rnd = _bf16
    else:
        def rnd(a):
            return a
    w1z = rnd(mats.w1z)
    if mats.w_out is None:
        return lambda z: torch.exp(rnd(z) @ w1z + by)
    w_out = rnd(mats.w_out)
    hidden = [(rnd(w), b) for w, b in mats.hidden]

    def dec(z):
        h = torch.tanh(rnd(z) @ w1z + by)
        for w, b in hidden:
            h = torch.tanh(rnd(h) @ w + b)
        return torch.exp(rnd(h) @ w_out + mats.b_out)

    return dec


def energy_planes(x2, vb, fast_stats: bool = False):
    """The f32 values of the planes ``x2``, ``vb`` that the chain's energy
    reads: as given, except that under ``fast_stats`` Vb is rounded to bf16
    (an f32 WF-mode plane; a bf16 one is already rounded)."""
    return x2.float(), (_bf16(vb) if fast_stats else vb)


def chain_energy(z, vs, x2e, vbe, g):
    """Per row, ``sum_f [log Vx + x2/Vx] + ||z||^2/2`` with
    ``Vx = max(g Vs + Vb, VX_FLOOR)``, on the planes of :func:`energy_planes`."""
    vx = (g[:, None] * vs + vbe).clamp_min(VX_FLOOR)
    return (torch.log(vx) + x2e / vx).sum(-1) + 0.5 * (z * z).sum(-1)


def mh_chain_reference(mats, x2, vb, g, z, y, noise, n_burn: int, n_samples: int,
                       var_rw: float, wf_mode: bool = False, fast_decoder: bool = False,
                       fast_stats: bool = False):
    """Plain PyTorch chain: the same contract as :func:`run_mh_chain`,
    written as a step loop on tensors (any device)."""
    _check(x2, vb, g, z, noise, mats, n_burn, n_samples, fast_decoder, fast_stats, wf_mode)
    dec = decoder_reference(mats, _fold_bias(mats, y, x2.shape[0], fast_decoder),
                            fast_decoder)
    l = z.shape[-1]
    sqrt_var = math.sqrt(var_rw)
    gg = g[:, None]
    x2e, vbe = energy_planes(x2, vb, fast_stats)

    def energy(z, vs):
        return chain_energy(z, vs, x2e, vbe, g)

    vs = dec(z)
    e = energy(z, vs)
    samples = []
    wfs = torch.zeros_like(x2e)
    wfn = torch.zeros_like(x2e)
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
                samples.append(vs.to(torch.bfloat16) if fast_stats else vs)
    if wf_mode:
        return z, wfs, wfn
    return z, torch.stack(samples)


@functools.cache
def build_library() -> ctypes.CDLL:
    """Compile ``csrc/mh_chain.cu`` for sm_90a into ``build/`` (once per
    source version), load it and declare its C interface (once per
    process)."""
    lib = load_library("mh_chain.cu")
    p, i, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    for launch in (lib.mh_chain_launch, lib.mh_chain_mma_launch):
        launch.argtypes = ([p] * 6 + [pp, pp, ctypes.POINTER(i), i, i] + [p] * 8 + [i] * 10
                           + [ctypes.c_float, p])
        launch.restype = i
    lib.mh_chain_smem_bytes.argtypes = [i, i, ctypes.POINTER(i)] + [i] * 5
    lib.mh_chain_smem_bytes.restype = ctypes.c_longlong
    lib.mh_chain_scratch_bytes.argtypes = [i, i]
    lib.mh_chain_scratch_bytes.restype = ctypes.c_longlong
    lib.mh_chain_resident_blocks.argtypes = [i, i, ctypes.POINTER(i)] + [i] * 6
    lib.mh_chain_resident_blocks.restype = i
    return lib


def _span(widths: tuple) -> tuple:
    """(H_0, H_max) of the hidden widths the body takes, (0, 0) for none."""
    return (widths[0], max(widths)) if widths else (0, 0)


@functools.cache
def _layout(f: int, l: int, widths: tuple, wf_mode: bool, mma: bool, stats: bool) -> int:
    """The index in :data:`LAYOUTS` of the first layout that takes the
    segment and whose block fits in shared memory. Raises ValueError when
    none fits (decided once for each shape)."""
    lib = build_library()

    def smem(layout):
        return lib.mh_chain_smem_bytes(f, l, _ptrs(widths, ctypes.c_int), len(widths),
                                       int(wf_mode), int(mma), int(stats), layout)

    for layout in range(len(LAYOUTS)):
        if 0 <= smem(layout) <= _MAX_SMEM:
            return layout
    raise ValueError(f"the MH-chain kernel's block needs {smem(len(LAYOUTS) - 1)} B of "
                     f"shared memory in its {LAYOUTS[-1]} layout (> {_MAX_SMEM}): F={f} "
                     f"L={l} H={widths}")


@functools.cache
def _blocks_at_once(device: int, f: int, l: int, widths: tuple, wf_mode: bool, mma: bool,
                    fast_stats: bool, layout: int) -> int:
    """Blocks of a layout's instantiation resident at once on CUDA device
    ``device``: the wide and resident layouts' grid at most (once for each
    shape)."""
    gen = not 1 <= len(widths) <= _ARGS_DEPTH
    with torch.cuda.device(device):
        n = build_library().mh_chain_resident_blocks(
            f, l, _ptrs(widths, ctypes.c_int), len(widths), int(wf_mode), int(mma), int(gen),
            int(fast_stats), layout)
    if n < 1:
        raise RuntimeError(f"mh_chain {LAYOUTS[layout]} layout: no block fits on the card "
                           f"(cudaError {-n})")
    return n


def _device_index(device) -> int:
    """The index of CUDA ``device`` (None: the current one)."""
    dev = torch.device("cuda" if device is None else device)
    return torch.cuda.current_device() if dev.index is None else dev.index


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


def _body_widths(mats, fast_decoder: bool) -> tuple:
    """The hidden widths the body takes: as they are for the bf16 body (it
    pads them to 16 itself), each odd one plus a zero unit for the f32 body
    (:func:`pad_decoder_f32`)."""
    return mats.widths if fast_decoder else tuple(h + h % 2 for h in mats.widths)


def chain_layout(mats, f: int, l: int, wf_mode: bool, fast_decoder: bool,
                 fast_stats: bool = False) -> str:
    """The layout (one of :data:`LAYOUTS`) in which the kernel runs this
    decoder's segments at F ``f`` and L ``l`` on the planes of
    ``fast_stats``."""
    return LAYOUTS[_layout(f, l, _body_widths(mats, fast_decoder), wf_mode, fast_decoder,
                           fast_stats)]


def wide_scratch_bytes(mats, rows: int, f: int, l: int, wf_mode: bool, fast_decoder: bool,
                       fast_stats: bool = False, device=None) -> int:
    """Bytes of global scratch a segment of ``rows`` rows allocates for its
    hidden activations on CUDA ``device``: one slot per block of its grid
    in the wide layout, which is at most the blocks resident at once, so it
    stops growing with the rows; 0 in the other layouts."""
    widths = _body_widths(mats, fast_decoder)
    layout = _layout(f, l, widths, wf_mode, fast_decoder, fast_stats)
    if LAYOUTS[layout] != "wide":
        return 0
    blocks = min(-(-rows // _TILE_ROWS),
                 _blocks_at_once(_device_index(device), f, l, widths, wf_mode, fast_decoder,
                                 fast_stats, layout))
    return blocks * build_library().mh_chain_scratch_bytes(_span(widths)[1], int(fast_decoder))


def _zero_pad(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``w`` zero-padded to (rows, cols); ``w`` itself when it has that
    shape."""
    k, n = w.shape
    if (k, n) == (rows, cols):
        return w
    return torch.nn.functional.pad(w, (0, cols - n, 0, rows - k)).contiguous()


def pack_decoder_mma(mats):
    """The decoder as the kernel's bf16 body reads it: ``(layers, w_out,
    b_out)``, ``layers`` the hidden layers' ``(packed weight, padded
    bias)`` pairs (the first layer's bias None: it is the row bias ``by``,
    which the kernel pads itself). L and the hidden widths are padded to
    multiples of 16 and F to a multiple of 8 with zero weights and zero
    biases; a padded hidden unit is tanh(0) = 0 and meets zero rows in the
    next layer, so the padding changes nothing. With no hidden layer:
    ``((), packed w1z, None)``, the output bias being ``by``."""
    if mats.w_out is None:
        return (), pack_mma_weight(mats.w1z, 8), None
    layers = ((pack_mma_weight(mats.w1z, 16), None),
              *((pack_mma_weight(w, 16), _pad(b, 16)) for w, b in mats.hidden))
    return layers, pack_mma_weight(mats.w_out, 8), _pad(mats.b_out, 8)


def pad_decoder_f32(mats):
    """The decoder as the kernel's f32 body reads it, in the layout of
    :func:`pack_decoder_mma`: the body reads two weight columns at a time,
    so each odd hidden width gets one zero unit (a zero column and bias,
    and a zero row in the next layer). Weights of even widths are kept as
    they are. With no hidden layer: ``((), w1z, None)``, the output bias
    being ``by``."""
    if mats.w_out is None:
        return (), mats.w1z, None
    even = _body_widths(mats, False)
    ins = (mats.w1z.shape[0], *even[:-1])
    ws = (mats.w1z, *(w for w, _ in mats.hidden))
    bs = (None, *(_pad(b, 2) for _, b in mats.hidden))
    layers = tuple((_zero_pad(w, k, h), b) for w, b, k, h in zip(ws, bs, ins, even))
    return layers, _zero_pad(mats.w_out, even[-1], mats.w_out.shape[1]), mats.b_out


# packs of the last few decoders, each kept with its source tensors so that
# their storage (and so their data_ptr) cannot be reused while cached
_PACKS: dict = {}
_PACKS_KEPT = 4


def _layer_table(layers) -> torch.Tensor | None:
    """The hidden layers as the kernel's device table (one ``(weight,
    bias, width)`` row of int64 per layer, the first bias 0) for a depth
    past :data:`_ARGS_DEPTH`, which the kernel's arguments do not carry;
    None otherwise (depth 0 has no layer to list)."""
    if len(layers) <= _ARGS_DEPTH:
        return None
    rows = [[w.data_ptr(), 0 if b is None else b.data_ptr(), w.shape[1]] for w, b in layers]
    return torch.tensor(rows, dtype=torch.int64).to(layers[0][0].device)


def _packed(mats, fast_decoder):
    """:func:`pack_decoder_mma` (or :func:`pad_decoder_f32`) of ``mats``
    and its :func:`_layer_table`, cached on the tensors' address, version
    counter and shape: the launches of one enhanced batch pack once, and
    new or updated weights pack anew."""
    src = tuple(t for t in (mats.w1z, *(t for layer in mats.hidden for t in layer), mats.w_out,
                            mats.b_out) if t is not None)
    key = (fast_decoder, *((t.data_ptr(), t._version, tuple(t.shape)) for t in src))
    hit = _PACKS.get(key)
    if hit is None:
        if len(_PACKS) >= _PACKS_KEPT:
            del _PACKS[next(iter(_PACKS))]
        pack = (pack_decoder_mma if fast_decoder else pad_decoder_f32)(mats)
        hit = _PACKS[key] = (src, (*pack, _layer_table(pack[0])))
    return hit[1]


def _ptrs(values, ctype):
    """A ctypes array of ``values`` (at least one entry)."""
    return (ctype * max(len(values), 1))(*values)


def _launch(mats, x2, vb, g, z, by, noise, n_burn, n_samples, var_rw, wf_mode,
            fast_decoder, fast_stats):
    global launches, launches_mma, launches_resident
    rows, f = x2.shape
    l = z.shape[-1]
    layers, w_out, b_out, table = _packed(mats, fast_decoder)
    widths = _body_widths(mats, fast_decoder)
    if fast_decoder:
        launch = build_library().mh_chain_mma_launch
    else:
        launch = build_library().mh_chain_launch
        if widths and widths[0] != by.shape[-1]:  # an odd first width: one zero bias column
            by = torch.nn.functional.pad(by, (0, 1)).contiguous()
        # the hidden layers read 2 weight columns at a time as one 8-byte load
        if any(w.data_ptr() % 8 for w, _ in layers):
            raise ValueError("the f32 body needs 8-byte aligned hidden weights")
    layout = _layout(f, l, widths, wf_mode, fast_decoder, fast_stats)
    resident = LAYOUTS[layout] == "resident"
    scratch, blocks = None, 0
    n_scratch = wide_scratch_bytes(mats, rows, f, l, wf_mode, fast_decoder, fast_stats,
                                   x2.device)
    if n_scratch:
        scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=x2.device)
        blocks = n_scratch // build_library().mh_chain_scratch_bytes(_span(widths)[1],
                                                                     int(fast_decoder))
    elif resident:
        blocks = _blocks_at_once(_device_index(x2.device), f, l, widths, wf_mode, fast_decoder,
                                 fast_stats, layout)
    ws = _ptrs([w.data_ptr() for w, _ in layers], ctypes.c_void_p)
    bs = _ptrs([None if b is None else b.data_ptr() for _, b in layers], ctypes.c_void_p)
    z_out = torch.empty((rows, l), device=x2.device)
    if wf_mode:
        outs = (torch.empty((rows, f), device=x2.device),
                torch.empty((rows, f), device=x2.device))
        samples_p, wfs_p, wfn_p = None, outs[0].data_ptr(), outs[1].data_ptr()
    else:
        outs = (torch.empty((n_samples, rows, f), device=x2.device,
                            dtype=torch.bfloat16 if fast_stats else torch.float32),)
        samples_p, wfs_p, wfn_p = outs[0].data_ptr(), None, None
    by_stride = by.shape[1] if by.dim() == 2 else 0
    with torch.cuda.device(x2.device):
        err = launch(
            x2.data_ptr(), vb.data_ptr(), g.data_ptr(), z.data_ptr(), by.data_ptr(),
            noise.data_ptr(), ws, bs, _ptrs(widths, ctypes.c_int), len(widths),
            _span(widths)[1], None if table is None else table.data_ptr(), w_out.data_ptr(),
            by.data_ptr() if b_out is None else b_out.data_ptr(), z_out.data_ptr(), samples_p,
            wfs_p, wfn_p, None if scratch is None else scratch.data_ptr(), blocks, rows, f, l,
            n_burn + n_samples, n_burn, by_stride, int(wf_mode), layout, int(fast_stats),
            math.sqrt(var_rw), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mh_chain kernel launch failed: cudaError {err} (F={f} L={l} "
                           f"H={mats.widths}, {LAYOUTS[layout]} layout)")
    launches += 1
    launches_mma += fast_decoder
    launches_resident += resident
    return (z_out, *outs)


def run_mh_chain(mats, x2, vb, g, z, y, noise, n_burn: int, n_samples: int,
                 var_rw: float, wf_mode: bool = False, fast_decoder: bool = False,
                 fast_stats: bool = False):
    """Run one MH chain segment on a flattened (rows, F) frame batch.

    Args:
        mats: decoder weights from :func:`extract_decoder_mlp`.
        x2, vb: (rows, F) mixture power / NMF noise variance, at the
            dtypes of :func:`plane_dtypes` (float32 unless ``fast_stats``).
        g: (rows,) gains; z: (rows, L) current latents.
        y: optional (rows, Y) conditioning labels, folded into the first
            layer's bias (with no hidden layer, the output layer's).
        noise: (n_burn + n_samples, rows, L + 1), see :func:`make_chain_noise`.
        fast_decoder: bf16 products with f32 sums (the tensor-core body,
            two hidden layers only) if True, f32 products if False.
        fast_stats: the energy on the bf16 planes, bf16 emission.
    Returns:
        E-step mode: ``(z_final (rows, L), vs_samples (n_samples, rows, F))``,
        the samples bfloat16 under ``fast_stats``.
        WF mode: ``(z_final, wfs_sum (rows, F), wfn_sum (rows, F))``.
    """
    _check(x2, vb, g, z, noise, mats, n_burn, n_samples, fast_decoder, fast_stats, wf_mode)
    if x2.device.type == "cpu":
        return mh_chain_reference(mats, x2, vb, g, z, y, noise, n_burn, n_samples,
                                  var_rw, wf_mode, fast_decoder, fast_stats)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    by = _fold_bias(mats, y, x2.shape[0], fast_decoder)
    return _launch(mats, x2, vb, g, z, by, noise, n_burn, n_samples, var_rw, wf_mode,
                   fast_decoder, fast_stats)

"""Masked multiplicative NMF updates for the MCEM noise model (port of
``dvae_tpu.enhance.nmf``).

Layouts are frames-major: X2 (B, N, F); W (B, F, K); H (B, N, K); g (B, N);
per-latent-sample speech variances Vs (R, B, N, F). The frame mask (B, N)
excludes padded frames from every reduction over N.

Update order: W (with Vx refresh), H (with Vx refresh), joint W/H column
renormalization with an eps-floored norm, then the gain g.

:func:`nmf_m_step` on CUDA tensors launches the fused kernel
``csrc/nmf_mstep.cu`` (built with ``nvcc`` at first use): two passes over
the samples, in three launches, laid out by :func:`mstep_plan`. On CPU
tensors it runs :func:`nmf_m_step_reference`, the plain PyTorch body; any
other device raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dvae_tpu_torch.build import load_library

# Absolute floor on the mixture variance Vx = g*Vs + Vb: guards digitally
# silent frames, where multiplicative updates drive g and H to exactly 0.
VX_FLOOR = 1e-10


def init_nmf(generator: torch.Generator, batch: int, n_frames: int, n_freq: int,
             rank: int, eps: float, device=None):
    """Random-uniform W/H (floored at eps) and unit gains."""
    w = torch.rand((batch, n_freq, rank), generator=generator, device=device).clamp_min(eps)
    h = torch.rand((batch, n_frames, rank), generator=generator, device=device).clamp_min(eps)
    g = torch.ones((batch, n_frames), device=device)
    return w, h, g


def compute_vb(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Noise variance Vb = W @ H in frames-major layout -> (B, N, F)."""
    return torch.einsum("bnk,bfk->bnf", h, w)


def nmf_m_step_reference(x2, vs, w, h, g, mask, eps: float = 1e-8):
    """One multiplicative M-step given latent-sample speech variances, in
    plain PyTorch (any device).

    Args:
        x2: (B, N, F) mixture power; vs: (R, B, N, F) speech variances,
            float32, or bfloat16 when the engine runs ``fast_stats``.
        w, h, g: current NMF parameters and gains; mask: (B, N) float.
    Returns:
        updated ``(w, h, g, vb)``, with ``vb = W @ H`` the final noise
        variance (g does not enter it).

    The arithmetic is f32 whatever ``vs``'s dtype: each expression that
    reads ``vs`` promotes it element by element, so no f32 copy of the
    samples is made. The R-sums ``a1``, ``a2`` are rounded to ``vs``'s
    dtype, as the JAX package stores them.
    """
    m = mask[:, :, None]
    ad = vs.dtype

    def vx(vb):
        return (g[None, :, :, None] * vs + vb[None]).clamp_min(VX_FLOOR)

    def r_sums(r1):
        """The paired reductions over R, at ``vs``'s dtype."""
        return r1.sum(0).to(ad), (r1 * r1).sum(0).to(ad)

    vb = compute_vb(w, h)
    # W: reduces over frames, so masked
    a1, a2 = r_sums(1.0 / vx(vb))
    num = torch.einsum("bnf,bnk->bfk", x2 * a2 * m, h)
    den = torch.einsum("bnf,bnk->bfk", a1 * m, h)
    w = w * torch.sqrt(num / den.clamp_min(eps))

    vb = compute_vb(w, h)
    # H: per frame, padded rows are harmless
    a1, a2 = r_sums(1.0 / vx(vb))
    num = torch.einsum("bnf,bfk->bnk", x2 * a2, w)
    den = torch.einsum("bnf,bfk->bnk", a1.float(), w)
    h = h * torch.sqrt(num / den.clamp_min(eps))

    # renormalize W's columns into H (W @ H unchanged); the norm is floored
    # at eps so a silent utterance (W's columns collapse to 0) stays finite
    norm = w.abs().sum(1).clamp_min(eps)  # (B, K)
    w = w / norm[:, None, :]
    h = h * norm[:, None, :]

    vb = compute_vb(w, h)
    r1 = 1.0 / vx(vb)
    # g: reduces over samples and frequency
    num = (x2[None] * vs * (r1 * r1)).sum((0, 3))
    den = (vs * r1).sum((0, 3))
    g = g * torch.sqrt(num / den.clamp_min(eps))
    return w, h, g, vb


# the H100's SMs, the dynamic shared memory one of its blocks may use, and
# the threads one SM holds
_SMS = 132
_MAX_SMEM = 232448
_SM_THREADS = 2048
# csrc/nmf_mstep.cu: its compiled rank chunks, the threads (frequencies) of
# a pass-1 block, the most threads of a finish block and warps of a pass-2
# block
_KC = (12, 16)
_T1 = 128
_MAX_THREADS_FIN = 576
_MAX_WARPS2 = 16
# pass 1: frames per block the plan chooses among, the longest that still
# gives this many waves of blocks; the blocks one SM holds (its registers,
# at 64 a thread)
_TILES1 = (8, 16, 32, 64)
_WAVES1 = 3
_RESIDENT1 = 8
# pass 2: the fewest warps a block stages rows for, the warps of a block
# that reads its samples from HBM, and the model of a warp's speed
_MIN_STAGED_WARPS = 4
_UNSTAGED_WARPS = 8
_WARP_SLACK = 6

# kernel launches since the last reset (each of a call's three counts)
launches = 0


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def _granules(n: int, elem: int) -> int:
    """16-byte granules that hold n elements of ``elem`` bytes at any
    alignment (the kernel's ``granules``)."""
    return (n * elem + 15) // 16 + 1


class MStepPlan(NamedTuple):
    """How ``csrc/nmf_mstep.cu`` lays out one M-step (its launch arguments).

    ``kc_t`` is the compiled rank chunk and ``kc`` the ranks of one pass-1
    block (``ceil(K / kc)`` blocks share a tile); ``fused``: K fits one
    chunk, so pass 2 takes H's sums in its first sweep; ``tile1`` frames
    per pass-1 block (of 128 frequencies), ``tiles`` of them per utterance;
    ``threads_fin`` threads per finish block; ``tile2`` frames per pass-2
    block and ``warps2`` warps, a row per warp; ``stage``: a pass-2 warp
    copies its row's samples into shared memory and both sweeps read them
    there (else both read HBM, the second from L2); ``w_smem2``: W' and
    W'' in shared memory (else read from global memory, as pass 1 reads
    W); ``smem1`` / ``smem2`` the blocks' dynamic shared memory in bytes;
    ``scratch`` the f32 scratch of a call.
    """

    kc_t: int
    kc: int
    fused: bool
    tile1: int
    tiles: int
    threads_fin: int
    smem1: int
    tile2: int
    warps2: int
    stage: bool
    w_smem2: bool
    smem2: int
    scratch: int


def _smem1(k: int, tile1: int) -> int:
    """``smem1_bytes`` of the kernel: the tile's H rows, gains and mask."""
    return 4 * (tile1 * k + 2 * tile1)


def _smem2(r: int, f: int, k: int, vs_bytes: int, warps: int, stage: bool, fused: bool,
           w_smem: bool) -> int:
    """``smem2_bytes`` of the kernel: W' and W'', then per warp the H of its
    row, x2 a2 and a1 (unless fused), and (staged) the row's R sample planes
    and x2."""
    per_warp = _align16(4 * k) + (0 if fused else _align16(8 * f))
    if stage:
        per_warp += (r * _granules(f, vs_bytes) + _granules(f, 4)) * 16
    return (_align16(8 * k * f) if w_smem else 0) + warps * per_warp


def _pass2_tile(r, b, n, f, k, vs_bytes, stage, fused, w_smem, warp_counts):
    """(frames, warps) of a pass-2 block: of the tiles that give each warp
    a whole number m of rows, the one whose grid finishes soonest. A warp
    takes m rows per wave of blocks, at a speed that falls with the warps
    w beside it on its SM as 1 / (w + _WARP_SLACK) (fitted to H100
    timings)."""
    def cost(w, m):
        smem = _smem2(r, f, k, vs_bytes, w, stage, fused, w_smem)
        resident = max(1, min(_SM_THREADS // (32 * w), _MAX_SMEM // smem))
        blocks = math.ceil(n / (w * m)) * b
        return math.ceil(blocks / (resident * _SMS)) * m * (w * resident + _WARP_SLACK)
    w, m = min(((w, m) for w in warp_counts for m in (1, 2, 3, 4, 6, 8)),
               key=lambda wm: (cost(*wm), -wm[0] * wm[1]))
    return w * m, w


@functools.lru_cache(maxsize=256)
def mstep_plan(r: int, b: int, n: int, f: int, k: int, vs_dtype: torch.dtype) -> MStepPlan:
    """The kernel's layout for R samples of (B, N, F) at ``vs_dtype`` and
    rank K, from those shapes alone.

    A pass-1 block gives each of 128 frequencies a thread and sums at most
    16 ranks in registers, so a larger K splits into groups of equal size,
    each recomputing the tile's R-sums; its tile of frames is the longest
    that still gives 3 waves of blocks (fewer partial sums to finish). W'
    and W'' (pass 2) sit in shared memory beside 4 staged warps where they
    fit in 227 KB. Pass 2 stages each row's samples in
    its warp's shared area where at least 4 warps' areas fit and every
    sample plane is a whole number of 16-byte granules, with 4 to 16 warps
    and tiles from :func:`_pass2_tile`; else it runs 8 warps that read the
    samples from HBM.
    """
    if vs_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes f32 or bf16 samples, got {vs_dtype}")
    vs_bytes = 2 if vs_dtype == torch.bfloat16 else 4
    kc = math.ceil(k / math.ceil(k / _KC[-1]))
    kc_t = next(c for c in _KC if c >= kc)
    fused = k <= kc_t
    groups = math.ceil(k / kc)
    threads_fin = min(32 * math.ceil(f / 32), _MAX_THREADS_FIN)

    resident1 = min(_RESIDENT1, _MAX_SMEM // _smem1(k, _TILES1[-1]))
    per_tile = b * math.ceil(f / _T1) * groups
    tile1 = next((t for t in reversed(_TILES1)
                  if math.ceil(n / t) * per_tile >= _WAVES1 * resident1 * _SMS), _TILES1[0])

    w_need = _align16(8 * k * f)
    w_smem2 = (w_need + _smem2(r, f, k, vs_bytes, _MIN_STAGED_WARPS, True, fused, False)
               <= _MAX_SMEM)
    per_warp = _smem2(r, f, k, vs_bytes, 1, True, fused, False)
    fit = (_MAX_SMEM - (w_need if w_smem2 else 0)) // per_warp
    # staged planes must share one offset in their granules
    stage = fit >= _MIN_STAGED_WARPS and (b * n * f * vs_bytes) % 16 == 0
    if not stage:
        w_smem2 = _smem2(r, f, k, vs_bytes, _UNSTAGED_WARPS, False, fused, True) <= _MAX_SMEM
    tile2, warps2 = _pass2_tile(r, b, n, f, k, vs_bytes, stage, fused, w_smem2,
                                range(_MIN_STAGED_WARPS, min(fit, _MAX_WARPS2) + 1) if stage
                                else (_UNSTAGED_WARPS,))
    smem2 = _smem2(r, f, k, vs_bytes, warps2, stage, fused, w_smem2)
    tiles = math.ceil(n / tile1)
    return MStepPlan(kc_t, kc, fused, tile1, tiles, threads_fin, _smem1(k, tile1),
                     tile2, warps2, stage,
                     w_smem2, smem2, b * tiles * 2 * k * f + 2 * b * k * f + b * k)


@functools.cache
def build_library() -> ctypes.CDLL:
    """Compile ``csrc/nmf_mstep.cu`` for sm_90a into ``build/`` (once per
    source version), load it and declare its C interface (once per
    process)."""
    lib = load_library("nmf_mstep.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nmf_mstep_launch.argtypes = [p] * 11 + [i] * 5 + [ctypes.c_float] + [i] * 9 + [p]
    lib.nmf_mstep_launch.restype = i
    lib.nmf_mstep_smem_bytes.argtypes = [i] * 10
    lib.nmf_mstep_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(x2, vs, w, h, g, mask) -> None:
    """Raise unless the kernel takes these tensors: one CUDA device, f32
    (the samples f32 or bf16), and shapes that agree."""
    ts = (x2, vs, w, h, g, mask)
    if any(t.device != x2.device for t in ts):
        raise ValueError("the M-step's tensors must share one device")
    if any(t.dtype != torch.float32 for t in (x2, w, h, g, mask)):
        raise TypeError("the kernel takes f32 x2, W, H, g and mask")
    if vs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes f32 or bf16 samples, got {vs.dtype}")
    if vs.dim() != 4 or x2.dim() != 3:
        raise ValueError("vs must be (R, B, N, F) and x2 (B, N, F)")
    r, b, n, f = vs.shape
    k = w.shape[-1]
    want = {"x2": (b, n, f), "w": (b, f, k), "h": (b, n, k), "g": (b, n), "mask": (b, n)}
    for name, t in zip(want, (x2, w, h, g, mask)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    if r < 1 or k < 1 or b > 65535 or k > 65535:
        raise ValueError(f"the kernel takes R >= 1, 1 <= K <= 65535, B <= 65535: "
                         f"R={r} B={b} K={k}")


def _launch(x2, vs, w, h, g, mask, eps: float, plan: MStepPlan | None = None):
    """The kernel on CUDA tensors -> ``(w, h, g, vb)`` as the plain body's;
    ``plan`` replaces :func:`mstep_plan`'s (for timing layouts)."""
    global launches
    _check(x2, vs, w, h, g, mask)
    r, b, n, f = vs.shape
    k = w.shape[-1]
    if plan is None:
        plan = mstep_plan(r, b, n, f, k, vs.dtype)
    x2, vs, w, h, g, mask = (t.contiguous() for t in (x2, vs, w, h, g, mask))
    lib = build_library()
    w_out, h_out, g_out, vb = (torch.empty_like(t) for t in (w, h, g, x2))
    scratch = torch.empty(plan.scratch, device=x2.device)
    with torch.cuda.device(x2.device):
        err = lib.nmf_mstep_launch(
            x2.data_ptr(), vs.data_ptr(), w.data_ptr(), h.data_ptr(), g.data_ptr(),
            mask.data_ptr(), w_out.data_ptr(), h_out.data_ptr(), g_out.data_ptr(),
            vb.data_ptr(), scratch.data_ptr(), r, b, n, f, k, eps,
            int(vs.dtype == torch.bfloat16), plan.kc_t, plan.kc, plan.tile1, plan.threads_fin,
            plan.tile2, plan.warps2, int(plan.stage), int(plan.w_smem2),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nmf_mstep kernel launch failed: cudaError {err}")
    if b:  # W's finish, and both passes unless there are no frames
        launches += 1 + 2 * (n > 0)
    return w_out, h_out, g_out, vb


def nmf_m_step(x2, vs, w, h, g, mask, eps: float = 1e-8):
    """One multiplicative M-step given latent-sample speech variances.

    Args:
        x2: (B, N, F) mixture power; vs: (R, B, N, F) speech variances,
            float32, or bfloat16 when the engine runs ``fast_stats``.
        w, h, g: current NMF parameters and gains; mask: (B, N) float.
    Returns:
        updated ``(w, h, g, vb)``, with ``vb = W @ H`` the final noise
        variance (g does not enter it).

    CPU tensors take :func:`nmf_m_step_reference`; CUDA tensors the fused
    kernel, which rounds every step the plain body rounds on its own
    (its R-sums to ``vs``'s dtype too) and sums over frames, frequencies
    and ranks in its own fixed order.
    """
    if x2.device.type == "cpu":
        return nmf_m_step_reference(x2, vs, w, h, g, mask, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    return _launch(x2, vs, w, h, g, mask, eps)

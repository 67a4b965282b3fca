"""A model of the MH-chain kernel's bf16 tensor-core body, in numpy.

The body (``mh_chain_mma_launch`` in ``dvae_tpu_torch/csrc/mh_chain.cu``)
multiplies through ``mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32``. Its
weights come from the host pack (``mh_chain.pack_mma_weight``), its A
fragments from bf16 activations in shared memory ([16][K + 8]), and its
epilogues read the accumulator fragment. This file writes the instruction's
lane mappings down as the PTX ISA gives them (``_a_at``, ``_b_at``,
``_c_at``), then assembles products fragment by fragment from the pack and
from the kernel's own load addresses, and holds them against the product
of the bf16-rounded operands. The operands are bf16 and the sums are taken
in float64, so a right layout gives the same numbers exactly: any wrong
lane, register half, k-step or n-tile shows as a mismatch.

It also counts the shared-memory wavefronts of the body's accesses (the A
fragment loads, the epilogue's bf16x2 stores and its float2 accesses of
the f32 planes), which the kernel's paddings make conflict-free.
"""

import numpy as np
import pytest
import torch

from dvae_tpu_torch.enhance.mh_chain import (
    DecoderMats,
    _fold_bias,
    decoder_reference,
    pack_decoder_mma,
    pack_mma_weight,
)
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

LANES = np.arange(32)
G, T = LANES // 4, LANES % 4  # groupID, threadID_in_group


def _a_at(i):
    """(row, col) of A element a_i (i < 8) in each lane, m16n8k16 .bf16."""
    return G + 8 * ((i // 2) % 2), 2 * T + (i % 2) + 8 * (i // 4)


def _b_at(i):
    """(row k, col n) of B element b_i (i < 4) in each lane."""
    return 2 * T + (i % 2) + 8 * (i // 2), G


def _c_at(i):
    """(row, col) of accumulator element c_i (i < 4) in each lane."""
    return G + 8 * (i // 2), 2 * T + (i % 2)


def _mma(a_frag, b_frag, c_frag):
    """The instruction on fragments: (32, 8) A, (32, 4) B and (32, 4) C
    register contents (element i of a lane in column i) -> D fragment."""
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    for i in range(8):
        a[_a_at(i)] = a_frag[:, i]
    for i in range(4):
        b[_b_at(i)] = b_frag[:, i]
    d = a @ b
    return c_frag + np.stack([d[_c_at(i)] for i in range(4)], axis=1)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _a_fragment(smem, lda, k0):
    """The kernel's A load for the k-step at column k0: four 32-bit words
    per lane at p = g lda + k0 + 2t, p + 8 lda, p + 8, p + 8 lda + 8, each
    two bf16 (the lower address in the lower half)."""
    p = G * lda + k0 + 2 * T
    words = [p, p + 8 * lda, p + 8, p + 8 * lda + 8]
    return np.stack([smem[w + h] for w in words for h in (0, 1)], axis=1)


def _smem_rows(act, k_pad):
    """Activations (16, K) as the kernel keeps them: bf16, [16][k_pad + 8],
    zero past K."""
    smem = np.zeros((16, k_pad + 8), np.float64)
    smem[:, : act.shape[1]] = _bf16(act)
    return smem.reshape(-1), k_pad + 8


def _tile_product(smem, lda, packed, nt):
    """D for n-tile nt, k-step by k-step, as mma_tiles computes it."""
    d = np.zeros((32, 4))
    for ks in range(packed.shape[0]):
        d = _mma(_a_fragment(smem, lda, 16 * ks), packed[ks, nt], d)
    return d


def _product(act, w, n_multiple):
    """act @ w through the pack and the fragments: (16, N padded)."""
    packed = pack_mma_weight(torch.from_numpy(w), n_multiple).float().numpy().astype(np.float64)
    ks_n, n_tiles = packed.shape[:2]
    smem, lda = _smem_rows(act, 16 * ks_n)
    out = np.zeros((16, 8 * n_tiles))
    for nt in range(n_tiles):
        d = _tile_product(smem, lda, packed, nt)
        for i in range(4):
            r, c = _c_at(i)
            out[r, 8 * nt + c] = d[:, i]
    return out, packed


# (L, H1, H2, F): M1's widths, the non-square stack, and widths that all
# need padding (L, H not multiples of 16, F odd and not a multiple of 8)
WIDTHS = [(16, 128, 128, 513), (16, 128, 64, 513), (10, 40, 24, 37)]


@pytest.mark.parametrize("widths", WIDTHS, ids=["m1", "nonsquare", "padded"])
def test_fragment_products_equal_bf16_products(widths):
    l, h1, h2, f = widths
    rng = np.random.default_rng(sum(widths))
    for k, n, mult in ((l, h1, 16), (h1, h2, 16), (h2, f, 8)):
        w = rng.standard_normal((k, n)).astype(np.float32)
        act = rng.standard_normal((16, k)).astype(np.float32)
        got, packed = _product(act, w, mult)
        k_pad, n_pad = -(-k // 16) * 16, -(-n // mult) * mult
        assert packed.shape == (k_pad // 16, n_pad // 8, 32, 4)
        want = _bf16(act).astype(np.float64) @ _bf16(w).astype(np.float64)
        np.testing.assert_array_equal(got[:, :n], want)
        assert not got[:, n:].any()  # padded columns are exactly zero
        # the pack holds the zero-padded bf16 weight, each entry once
        rebuilt = np.zeros((k_pad, n_pad))
        seen = np.zeros((k_pad, n_pad), int)
        for ks in range(k_pad // 16):
            for nt in range(n_pad // 8):
                for i in range(4):
                    kk, nn = _b_at(i)
                    rebuilt[16 * ks + kk, 8 * nt + nn] = packed[ks, nt, :, i]
                    seen[16 * ks + kk, 8 * nt + nn] += 1
        assert (seen == 1).all()
        np.testing.assert_array_equal(rebuilt[:k, :n], _bf16(w))
        assert not rebuilt[k:].any() and not rebuilt[:, n:].any()


def test_pack_sizes_at_m1_widths():
    """W1 4 KB, W2 32 KB, W3 (128 x 520) 133,120 B; biases padded to 16 / 8."""
    mats = DecoderMats(torch.randn(16, 128), None, torch.randn(128),
                       ((torch.randn(128, 128), torch.randn(128)),), torch.randn(128, 513),
                       torch.randn(513))
    ((w1p, b1p), (w2p, b2p)), w3p, b3p = pack_decoder_mma(mats)
    assert b1p is None
    sizes = [t.numel() * t.element_size() for t in (w1p, w2p, w3p)]
    assert sizes == [4096, 32768, 133120]
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in (w1p, w2p, w3p))
    assert b2p.shape == (128,) and b3p.shape == (520,) and not b3p[513:].any()


def _epilogue_store(out, ldo, nt, d, f):
    """The kernel's layer epilogue placement: lane (g, t) writes c_i to row
    g + 8 (i // 2), column 8 nt + 2t + i % 2."""
    for i in range(4):
        r, c = G + 8 * (i // 2), 8 * nt + 2 * T + (i % 2)
        out[r * ldo + c] = f(d[:, i], c)


@pytest.mark.parametrize("widths", WIDTHS, ids=["m1", "nonsquare", "padded"])
def test_fragment_decoder_matches_plain_bf16_decoder(widths):
    """The whole decode as the body runs it (z' to bf16 in shared memory,
    two tanh epilogues storing bf16, the exp epilogue) against the plain
    ``fast_decoder`` decoder. The model sums in float64 and the plain
    decoder in float32, so a pre-activation within float32 rounding of a
    bf16 rounding boundary may round the other way: agreement to 1e-5
    relative on at least 99% of the elements, and 5e-3 everywhere."""
    l, h1, h2, f = widths
    rng = np.random.default_rng(7)
    w1, w2, w3 = (rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
                  for k, n in ((l, h1), (h1, h2), (h2, f)))
    b1, b2, b3 = (0.1 * rng.standard_normal(n).astype(np.float32) for n in (h1, h2, f))
    w1, b1, w2, b2, w3, b3 = (torch.from_numpy(m) for m in (w1, b1, w2, b2, w3, b3))
    mats = DecoderMats(w1, None, b1, ((w2, b2),), w3, b3)
    ((w1p, _), (w2p, b2p)), w3p, b3p = pack_decoder_mma(mats)
    w1p, w2p, w3p, b2p, b3p = (t.float().numpy().astype(np.float64)
                               for t in (w1p, w2p, w3p, b2p, b3p))
    b1 = b1.numpy()
    z = rng.standard_normal((16, l)).astype(np.float32)
    l16, h1p, h2p = (-(-n // 16) * 16 for n in (l, h1, h2))

    act, lda = _smem_rows(z, l16)
    for packed, n_pad, bias in ((w1p, h1p, lambda c: np.where(c < h1, b1[np.minimum(c, h1 - 1)], 0.0)),
                                (w2p, h2p, lambda c: b2p[c])):
        out = np.zeros(16 * (n_pad + 8))
        for nt in range(n_pad // 8):
            d = _tile_product(act, lda, packed, nt)
            _epilogue_store(out, n_pad + 8, nt, d,
                            lambda v, c: _bf16(np.tanh((v + bias(c)).astype(np.float32))))
        act, lda = out, n_pad + 8
    vs = np.zeros(16 * (f + 8))
    for nt in range(w3p.shape[1]):
        d = _tile_product(act, lda, w3p, nt)
        _epilogue_store(vs, f + 8, nt, d, lambda v, c: np.exp((v + b3p[c]).astype(np.float32)))
    vs = vs.reshape(16, f + 8)[:, :f]

    want = decoder_reference(mats, _fold_bias(mats, None, 16, True), True)(
        torch.from_numpy(z)).numpy()
    rel = np.abs(vs - want) / np.abs(want)
    assert rel.max() < 5e-3 and (rel < 1e-5).mean() >= 0.99


def _wavefronts(word_addrs, words_per_lane=1):
    """Shared-memory wavefronts of one warp access: 32-bit accesses take one
    pass per distinct word in the busiest bank; 64-bit accesses are served a
    half warp at a time."""
    lanes_per_phase = 32 // words_per_lane
    total = 0
    for p0 in range(0, 32, lanes_per_phase):
        banks = {}
        for lane in range(p0, p0 + lanes_per_phase):
            for w in range(words_per_lane):
                a = int(word_addrs[lane]) + w
                banks.setdefault(a % 32, set()).add(a)
        total += max(len(s) for s in banks.values())
    return total


def _plane_ld(f):
    """The kernel's row stride of the f32 planes in the bf16 body
    (``plane_ld<true>`` in mh_chain.cu)."""
    return (f + 7) // 16 * 16 + 8


@pytest.mark.parametrize("k_pad", [16, 32, 64, 128, 256])
def test_a_loads_and_epilogue_stores_are_conflict_free(k_pad):
    """Rows of k_pad + 8 bf16: each 32-bit A-fragment load, and each bf16x2
    store of an epilogue into the next layer's rows, is one wavefront."""
    words = k_pad // 2 + 4  # row stride in 32-bit words
    for k0 in range(0, k_pad, 16):
        p = G * (k_pad + 8) + k0 + 2 * T  # in bf16
        for off in (0, 8 * (k_pad + 8), 8, 8 * (k_pad + 8) + 8):
            assert _wavefronts((p + off) // 2) == 1
    for nt in range(k_pad // 8):
        for hh in (0, 1):
            assert _wavefronts((G + 8 * hh) * words + 4 * nt + T) == 1


@pytest.mark.parametrize("f", [513, 512, 257, 1025, 37])
def test_plane_accesses_are_conflict_free(f):
    """The layer-3 epilogue's float2 accesses of the x2, Vb and Vs planes
    take one wavefront per half warp (the fewest for 64-bit accesses)."""
    ld = _plane_ld(f)
    assert ld >= -(-f // 8) * 8 and ld % 8 == 0
    for nt in range(-(-f // 8)):
        for hh in (0, 1):
            assert _wavefronts((G + 8 * hh) * ld + 8 * nt + 2 * T, words_per_lane=2) == 2
    # at the plain stride F the same accesses conflict
    if f == 513:
        assert _wavefronts(G * f + 2 * T) > 1


# ---- the resident layout (E-step segments on bf16 planes at depth 2): the
# packed decoder in shared memory, the planes in the registers of the lanes
# whose layer-3 accumulators produce them

# layer 3's warps, the block's warps, layer-3 n-tiles a lane holds, rows of a tile
NWM, NWR, NTW, TR = 13, 16, 5, 16
MAX_SMEM = 232448


def _r16(n):
    return -(-n // 16) * 16


def _resident_smem(f, l, widths, wf_mode=False, fast_decoder=True, fast_stats=True):
    """Bytes of the resident layout's block as ``csrc/mh_chain.cu`` counts
    them (``layout_smem``), None where the layout does not take the
    segment: the packed weights, the padded biases of layers 2 and 3, the
    tile's first-layer bias [TR][H0_16] (per row or not), z' [L][TR], the
    partial energies [NWM][TR], ||z'||^2, the acceptances and the accepted
    halves, the bf16 activations z', h1, h2 at rows of K16 + 8, and
    bf16(Vs) double-buffered at the planes' row stride."""
    if not (fast_decoder and fast_stats and not wf_mode and len(widths) == 2):
        return None
    f8 = -(-f // 8) * 8
    if f8 // 8 > NWM * NTW or TR * (l + 1) > NWR * 32:
        return None
    h0, h1 = widths

    def frags(k, n):
        return _r16(k) // 16 * (-(-n // 8)) * 32

    uint2s = frags(l, _r16(h0)) + frags(h0, _r16(h1)) + frags(h1, f8)
    floats = _r16(h1) + f8 + TR * _r16(h0) + TR * l + NWM * TR + 3 * TR
    halves = TR * (_r16(l) + 8 + _r16(h0) + 8 + _r16(h1) + 8) + 2 * TR * _plane_ld(f)
    return 8 * uint2s + 4 * floats + 2 * halves


def _lane_elements(warp, f):
    """(row, column) of each accumulator element a lane of ``warp`` holds
    across its layer-3 n-tiles warp + NWM i: register (i, hh, e) is c_(2 hh
    + e) of n-tile i, as the m16n8k16 accumulator lays it out."""
    out = {}
    for i in range(NTW):
        nt = warp + NWM * i
        for c_i in range(4):
            r, c = _c_at(c_i)
            out[(i, c_i)] = (r, 8 * nt + c)
    return out


@pytest.mark.parametrize("f", [513, 512, 257, 37])
def test_resident_planes_cover_each_element_once(f):
    """Every (row < 16, column < F) of a tile's planes is held by exactly
    one (warp, lane, register), and the register is the accumulator
    element of layer 3 that produces it."""
    seen = np.zeros((TR, f), int)
    for warp in range(NWM):
        for (i, c_i), (rows, cols) in _lane_elements(warp, f).items():
            # the kernel's own index arithmetic for register (i, hh, e)
            hh, e = c_i // 2, c_i % 2
            assert (rows == G + 8 * hh).all()
            assert (cols == (warp + NWM * i) * 8 + 2 * T + e).all()
            for r, c in zip(rows, cols):
                if c < f:
                    seen[r, c] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("l", [16, 10, 31])
def test_resident_noise_values_have_one_thread_each(l):
    """Thread r (L + 1) + c carries noise value c of row r: one thread for
    each of the step's TR x (L + 1) values, within the block."""
    tids = [r * (l + 1) + c for r in range(TR) for c in range(l + 1)]
    assert sorted(tids) == list(range(TR * (l + 1))) and max(tids) < NWR * 32


@pytest.mark.parametrize("widths", WIDTHS, ids=["m1", "nonsquare", "padded"])
def test_resident_weight_reads_are_conflict_free(widths):
    """The packed weights sit back to back in shared memory; each warp's
    B-fragment read (8 bytes a lane, lane after lane) is two wavefronts,
    the fewest for 64-bit accesses, at every k-step and n-tile of each
    layer, and so are the output bias's float2 reads (four addresses, each
    read by the lanes of one t)."""
    l, h1, h2, f = widths
    mats = DecoderMats(torch.randn(l, h1), None, torch.randn(h1), ((torch.randn(h1, h2),
                       torch.randn(h2)),), torch.randn(h2, f), torch.randn(f))
    ((w1p, _), (w2p, _)), wop, _ = pack_decoder_mma(mats)
    base = 0  # in 32-bit words
    for packed in (w1p, w2p, wop):
        ks_n, n_tiles = packed.shape[:2]
        for ks in range(ks_n):
            for nt in range(n_tiles):
                words = base + 2 * ((ks * n_tiles + nt) * 32 + LANES)
                assert _wavefronts(words, words_per_lane=2) == 2
        base += packed.numel() // 2
    assert base % 4 == 0  # the biases after the weights stay 16-byte aligned
    for nt in range(-(-f // 8)):
        assert _wavefronts(8 * nt + 2 * T, words_per_lane=2) == 2


def test_resident_weights_are_the_pack():
    """The layout's weight area is exactly the pack's bytes (169,984 at
    M1's widths), beside 55,584 B of the rest."""
    mats = DecoderMats(torch.randn(16, 128), None, torch.randn(128),
                       ((torch.randn(128, 128), torch.randn(128)),), torch.randn(128, 513),
                       torch.randn(513))
    ((w1p, _), (w2p, _)), wop, _ = pack_decoder_mma(mats)
    packed = sum(t.numel() * t.element_size() for t in (w1p, w2p, wop))
    assert packed == 169984
    rest = 4 * (128 + 520 + TR * 128 + TR * 16 + NWM * TR + 3 * TR) + 2 * TR * (
        24 + 136 + 136 + 2 * 520)
    assert rest == 55584
    assert _resident_smem(513, 16, (128, 128)) == packed + rest == 225568


@pytest.mark.parametrize("row_bias", [False, True], ids=["m1", "m2info"])
def test_resident_fits_at_the_main_path(row_bias):
    """M1 (one first-layer bias) and M2-info (a folded row bias) take the
    same block: the tile's bias slab is [TR][H0] either way."""
    mats = DecoderMats(torch.randn(16, 128), None, torch.randn(128),
                       ((torch.randn(128, 128), torch.randn(128)),), torch.randn(128, 513),
                       torch.randn(513))
    if row_bias:
        mats = _fold_bias_mats(mats, rows=64)
        assert mats.b1.shape == (64, 128)
    assert _resident_smem(513, 16, mats.widths) <= MAX_SMEM


def _fold_bias_mats(mats, rows):
    w1y = torch.randn(1, mats.w1z.shape[1])
    y = torch.rand(rows, 1)
    return mats._replace(w1y=None, b1=_fold_bias(mats._replace(w1y=w1y), y, rows, True))


@pytest.mark.parametrize("case", [
    dict(widths=(256, 256)), dict(widths=(128, 128), wf_mode=True),
    dict(widths=(128, 128), fast_stats=False), dict(widths=(128, 128), fast_decoder=False),
    dict(widths=(128, 128, 128)), dict(widths=(128, 128), f=1025),
    dict(widths=(128, 128), l=32)],
    ids=["h256", "wf", "f32-planes", "f32-body", "depth3", "f1025", "l32"])
def test_resident_refuses_what_it_does_not_take(case):
    """Decoders too wide for shared memory (H 256/256: W_out alone is 266
    KB), WF segments, f32 planes, the f32 body, other depths, more layer-3
    n-tiles than the lanes hold, more noise values than threads."""
    case = dict(case)
    f, l = case.pop("f", 513), case.pop("l", 16)
    got = _resident_smem(f, l, **case)
    assert got is None or got > MAX_SMEM


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_resident_smem_matches_the_kernel(cuda):
    """The kernel counts the resident block as :func:`_resident_smem`
    does, and refuses the segments it does not take (-1); the wrapper
    picks the layout where it fits."""
    import ctypes

    from dvae_tpu_torch.enhance import mh_chain

    lib = mh_chain.build_library()
    resident = mh_chain.LAYOUTS.index("resident")
    cases = [(513, 16, (128, 128)), (513, 16, (128, 64)), (513, 10, (100, 40)),
             (257, 16, (128, 256)), (513, 16, (256, 256)), (1025, 16, (64, 64)),
             (513, 16, (128, 128, 128))]
    for f, l, widths in cases:
        for wf, stats, mma in ((False, True, True), (True, True, True), (False, False, True),
                               (False, True, False)):
            want = _resident_smem(f, l, widths, wf, mma, stats)
            got = lib.mh_chain_smem_bytes(f, l, (ctypes.c_int * len(widths))(*widths),
                                          len(widths), int(wf), int(mma), int(stats), resident)
            assert got == (-1 if want is None else want), (f, l, widths, wf, stats, mma)
    mats = DecoderMats(torch.randn(16, 128), None, torch.randn(128),
                       ((torch.randn(128, 128), torch.randn(128)),), torch.randn(128, 513),
                       torch.randn(513))
    assert mh_chain.chain_layout(mats, 513, 16, False, True, True) == "resident"
    assert mh_chain.chain_layout(mats, 513, 16, True, True, True) == "shared"
    assert mh_chain.chain_layout(mats, 513, 16, False, True, False) == "shared"

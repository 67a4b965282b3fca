"""The fused NMF M-step kernel (``csrc/nmf_mstep.cu``) and its launch plan.

CPU tests: the launch plan (``nmf.mstep_plan``) at the benchmark cells'
shapes and beyond; a CPU tensor still takes the plain body, bit for bit
against a copy of it kept here; and a pure-torch model of the kernel's
pass structure (per-tile partial sums of W's update finished in tile
order, then row-local H, g and Vb) agrees with ``nmf_m_step``.

Card tests (``cuda`` marker; they skip without a CUDA device, since the
kernel has no CPU mode), run there by
    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_port_nmf_kernel.py
hold the kernel against the plain body on the card, and against the JAX
package's M-step through ``data/nmf_mstep_jax.npz``: the card's machine
has no JAX, so the JAX M-step's results on seeded inputs at the offline
cells' R, F and K (B and N cut so the file stays small) are kept there,
and a CPU test checks that JAX still gives them. Rewrite the file with
    JAX_PLATFORMS=cpu python tests/test_torch_port_nmf_kernel.py --write-jax-fixture
Tolerances, as the
relative L2 of each utterance's W, H, g and Vb: the kernel rounds every
step the plain body rounds on its own, so on f32 samples only the order of
the sums over frames, frequencies, ranks and samples differs (1e-5). On
bf16 samples an R-sum within rounding of a bf16 boundary may round the
other way and move its element by one bf16 ulp (2^-8), which the sums
over N and F dilute: 1e-4, the benchmark's ``mstep_rel`` limit.
"""

import os
import sys

import numpy as np
import pytest
import torch

from dvae_tpu_torch.enhance import nmf
from dvae_tpu_torch.enhance.nmf import VX_FLOOR
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

BF16, F32 = torch.bfloat16, torch.float32
SMEM = 232448  # the H100's 227 KB of shared memory per block


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(r, b, n, f, k, dtype, seed=0, silent=(), device="cpu"):
    """Random samples, NMF state and gains; utterance i has ``3 i`` padded
    frames (mod n/2); the utterances in ``silent`` have x2 = 0."""
    gen = torch.Generator().manual_seed(seed)
    x2 = torch.rand((b, n, f), generator=gen) ** 2 * 4 + 1e-3
    for i in silent:
        x2[i] = 0.0
    vs = (torch.rand((r, b, n, f), generator=gen) + 0.05).to(dtype)
    w = torch.rand((b, f, k), generator=gen).clamp_min(1e-8)
    h = torch.rand((b, n, k), generator=gen).clamp_min(1e-8)
    g = torch.rand((b, n), generator=gen) + 0.5
    mask = torch.ones((b, n))
    for i in range(b):
        pad = (3 * i) % max(n // 2, 1)
        if pad:
            mask[i, n - pad:] = 0.0
    return tuple(t.to(device) for t in (x2, vs, w, h, g, mask))


def _rel(a, b):
    """Per utterance, ||a - b|| / ||b|| (||a - b|| where b is all zero)."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    d, n = (a - b).norm(dim=1), b.norm(dim=1)
    return float(torch.where(n > 0, d / n.clamp_min(1e-300), d).max())


# --- the launch plan ---------------------------------------------------------


def _smem2(r, f, k, vs_bytes, warps, stage, fused, w_smem):
    """The kernel's pass-2 shared memory, written out: W' and W'', then per
    warp its row's H, x2 a2 and a1 unless fused, and staged rows' planes."""
    def up16(x):
        return -(-x // 16) * 16

    per_warp = up16(4 * k) + (0 if fused else up16(8 * f))
    if stage:
        per_warp += (r * ((f * vs_bytes + 15) // 16 + 1) + (f * 4 + 15) // 16 + 1) * 16
    return (up16(8 * k * f) if w_smem else 0) + warps * per_warp


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("f", [257, 513])
@pytest.mark.parametrize("k", [1, 10, 37])
@pytest.mark.parametrize("r", [1, 10, 30])
def test_plan_at_cell_shapes(r, k, f, dtype):
    """Tiles, threads, rank groups, staging and shared memory of the plan at
    the cells' batches (32 offline, 8 served) and the engines' R and K."""
    vs_bytes = 2 if dtype == BF16 else 4
    for b, n in ((32, 320), (32, 128), (8, 320)):
        p = nmf.mstep_plan(r, b, n, f, k, dtype)
        assert p.threads_fin == min(32 * -(-f // 32), 576)
        assert p.kc <= p.kc_t <= 16 and p.kc_t in (12, 16)
        groups = -(-k // p.kc)
        assert groups == -(-k // 16) and (groups - 1) * p.kc < k
        assert p.fused == (k <= p.kc_t)
        # pass 1: the longest tile that still gives three waves of 8 blocks per SM
        assert p.tiles == -(-n // p.tile1) and p.tile1 in (8, 16, 32, 64)
        blocks = lambda t: -(-n // t) * b * -(-f // 128) * groups  # noqa: E731
        assert p.tile1 == 8 or blocks(p.tile1) >= 3 * 8 * 132
        assert p.tile1 == 64 or blocks(2 * p.tile1) < 3 * 8 * 132
        assert p.smem1 == 4 * (p.tile1 * k + 2 * p.tile1)
        # pass 2: W' and W'' in shared memory where they fit beside 4 staged
        # warps; rows staged where 4 warps' areas fit in what is left
        w_need = _smem2(r, f, k, vs_bytes, 0, True, p.fused, True)
        per_warp = _smem2(r, f, k, vs_bytes, 1, True, p.fused, False)
        w_beside = w_need + 4 * per_warp <= SMEM
        fit = (SMEM - (w_need if w_beside else 0)) // per_warp
        assert p.stage == (fit >= 4)
        if p.stage:
            assert 4 <= p.warps2 <= min(fit, 16) and p.w_smem2 == w_beside
        else:
            assert p.warps2 == 8
        assert p.tile2 % p.warps2 == 0 and p.tile2 // p.warps2 in (1, 2, 3, 4, 6, 8)
        assert p.smem2 == _smem2(r, f, k, vs_bytes, p.warps2, p.stage, p.fused, p.w_smem2)
        assert max(p.smem1, p.smem2) <= SMEM
        assert p.scratch == b * p.tiles * 2 * k * f + 2 * b * k * f + b * k
    main = nmf.mstep_plan(10, 32, 320, 513, 10, BF16)
    assert (main.tile1, main.tile2, main.warps2, main.kc_t, main.stage) == (16, 84, 14, 12, True)


@pytest.mark.parametrize("f", [129, 257, 513, 1025])
def test_plan_never_exceeds_shared_memory(f):
    """Across R, K and batch shapes: no block asks for more than 227 KB;
    where a row's samples do not fit beside W' and W'' (or their planes
    are not whole 16-byte granules) the plan reads them again from L2, and
    where W' and W'' do not fit it reads them from global memory."""
    for dtype in (BF16, F32):
        vs_bytes = 2 if dtype == BF16 else 4
        for r in (1, 4, 10, 30, 64):
            for k in (1, 10, 37, 64, 200):
                for b, n in ((1, 7), (8, 320), (32, 400), (3, 173)):
                    p = nmf.mstep_plan(r, b, n, f, k, dtype)
                    assert p.smem1 <= SMEM and p.smem2 <= SMEM
                    assert p.warps2 <= 16 and p.threads_fin <= 576
                    if p.stage:
                        assert (b * n * f * vs_bytes) % 16 == 0 and p.warps2 >= 4
    assert not nmf.mstep_plan(30, 32, 320, 513, 10, F32).stage
    assert not nmf.mstep_plan(10, 3, 173, 513, 10, BF16).stage
    assert not nmf.mstep_plan(10, 32, 320, 513, 200, F32).w_smem2


def test_plan_rejects_other_sample_dtypes():
    with pytest.raises(ValueError, match="f32 or bf16"):
        nmf.mstep_plan(10, 32, 320, 513, 10, torch.float16)


# --- the CPU path --------------------------------------------------------------


def _plain_body(x2, vs, w, h, g, mask, eps=1e-8):
    """A copy of ``nmf_m_step``'s plain body as it was before the kernel."""
    m = mask[:, :, None]
    ad = vs.dtype

    def vx(vb):
        return (g[None, :, :, None] * vs + vb[None]).clamp_min(VX_FLOOR)

    def r_sums(r1):
        return r1.sum(0).to(ad), (r1 * r1).sum(0).to(ad)

    vb = nmf.compute_vb(w, h)
    a1, a2 = r_sums(1.0 / vx(vb))
    num = torch.einsum("bnf,bnk->bfk", x2 * a2 * m, h)
    den = torch.einsum("bnf,bnk->bfk", a1 * m, h)
    w = w * torch.sqrt(num / den.clamp_min(eps))

    vb = nmf.compute_vb(w, h)
    a1, a2 = r_sums(1.0 / vx(vb))
    num = torch.einsum("bnf,bfk->bnk", x2 * a2, w)
    den = torch.einsum("bnf,bfk->bnk", a1.float(), w)
    h = h * torch.sqrt(num / den.clamp_min(eps))

    norm = w.abs().sum(1).clamp_min(eps)
    w = w / norm[:, None, :]
    h = h * norm[:, None, :]

    vb = nmf.compute_vb(w, h)
    r1 = 1.0 / vx(vb)
    num = (x2[None] * vs * (r1 * r1)).sum((0, 3))
    den = (vs * r1).sum((0, 3))
    g = g * torch.sqrt(num / den.clamp_min(eps))
    return w, h, g, vb


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_cpu_tensors_take_the_plain_body_bit_for_bit(dtype):
    before = nmf.launches
    args = _inputs(3, 2, 20, 65, 4, dtype, seed=1, silent=(1,))
    got = nmf.nmf_m_step(*args)
    want = _plain_body(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert nmf.launches == before


def test_other_devices_raise():
    args = _inputs(2, 1, 4, 9, 2, F32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nmf.nmf_m_step(*args)


def _pass_model(x2, vs, w, h, g, mask, eps, tile):
    """The kernel's passes in torch: pass 1's partial sums of W's update per
    tile of ``tile`` frames, summed in tile order, W' and its norms; then
    pass 2, each frame row on its own: Vb at W', the R-sums, H's update,
    Vb at the renormalised pair and g's update. R-sums run sample by sample
    in f32 and round to the samples' dtype."""
    ad, vs = vs.dtype, vs.float()
    m = mask[:, :, None]

    def r_sums(vb):
        s1 = s2 = torch.zeros_like(vb)
        for s in vs:
            q = 1.0 / (g[:, :, None] * s + vb).clamp_min(VX_FLOOR)
            s1, s2 = s1 + q, s2 + q * q
        return s1.to(ad).float(), s2.to(ad).float()

    a1, a2 = r_sums(torch.einsum("bnk,bfk->bnf", h, w))
    t2, t1 = x2 * a2 * m, a1 * m
    num = den = torch.zeros_like(w)
    for n0 in range(0, x2.shape[1], tile):
        rows = slice(n0, n0 + tile)
        num = num + torch.einsum("bnf,bnk->bfk", t2[:, rows], h[:, rows])
        den = den + torch.einsum("bnf,bnk->bfk", t1[:, rows], h[:, rows])
    wp = w * torch.sqrt(num / den.clamp_min(eps))
    norm = wp.abs().sum(1).clamp_min(eps)[:, None, :]
    wpp = wp / norm

    a1, a2 = r_sums(torch.einsum("bnk,bfk->bnf", h, wp))
    hn = torch.einsum("bnf,bfk->bnk", x2 * a2, wp)
    hd = torch.einsum("bnf,bfk->bnk", a1, wp)
    hpp = h * torch.sqrt(hn / hd.clamp_min(eps)) * norm
    vb = torch.einsum("bnk,bfk->bnf", hpp, wpp)
    sn = sd = torch.zeros_like(g)
    for s in vs:
        q = 1.0 / (g[:, :, None] * s + vb).clamp_min(VX_FLOOR)
        sn = sn + (x2 * s * (q * q)).sum(-1)
        sd = sd + (s * q).sum(-1)
    return wpp, hpp, g * torch.sqrt(sn / sd.clamp_min(eps)), vb


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", ["random", "masked", "silent"])
def test_pass_model_matches_the_m_step(batch, dtype):
    """Partial sums finished in tile order, then row-local H, g and Vb,
    agree with ``nmf_m_step`` to 1e-6 relative (summation order only)."""
    r, b, n, f, k = 4, 3, 37, 65, 5
    x2, vs, w, h, g, mask = _inputs(r, b, n, f, k, dtype, seed=2,
                                    silent=range(b) if batch == "silent" else ())
    if batch == "random":
        mask = torch.ones_like(mask)
    tile = nmf.mstep_plan(r, b, n, f, k, dtype).tile1
    assert tile < n  # several tiles, the last one partial
    got = _pass_model(x2, vs, w, h, g, mask, 1e-8, tile)
    want = nmf.nmf_m_step(x2, vs, w, h, g, mask, 1e-8)
    for a, b_ in zip(got, want):
        assert _rel(a, b_) <= 1e-6
    if batch == "silent":
        assert all(bool(torch.isfinite(t).all()) for t in got)
        assert float(got[0].abs().max()) == 0.0 and float(got[2].abs().max()) == 0.0


# --- against the JAX package ---------------------------------------------------

JAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "nmf_mstep_jax.npz")
JAX_SHAPE = (10, 3, 40, 513, 10)  # (R, B, N, F, K): the offline cells' R, F, K


def _jax_case(tag):
    """Seeded numpy inputs at JAX_SHAPE (the same on any machine): padded
    frames in two utterances, the last utterance silent; the samples
    rounded to bf16 for ``tag`` "bf16"."""
    r, b, n, f, k = JAX_SHAPE
    rng = np.random.default_rng(22)
    x2 = (rng.uniform(size=(b, n, f)) ** 2 * 4 + 1e-3).astype(np.float32)
    x2[b - 1] = 0.0
    vs = (rng.uniform(size=(r, b, n, f)) + 0.05).astype(np.float32)
    w = np.maximum(rng.uniform(size=(b, f, k)), 1e-8).astype(np.float32)
    h = np.maximum(rng.uniform(size=(b, n, k)), 1e-8).astype(np.float32)
    g = (rng.uniform(size=(b, n)) + 0.5).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    for i in range(b):
        mask[i, n - 7 * i:] = 0.0
    ts = [torch.from_numpy(a) for a in (x2, vs, w, h, g, mask)]
    if tag == "bf16":
        ts[1] = ts[1].to(BF16)
    return ts


def _jax_m_step(tag):
    """The JAX package's M-step on :func:`_jax_case`'s inputs, as numpy."""
    import jax.numpy as jnp

    from dvae_tpu.enhance import nmf as jnmf

    x2, vs, w, h, g, mask = (jnp.asarray(t.float().numpy()) for t in _jax_case(tag))
    if tag == "bf16":
        vs = vs.astype(jnp.bfloat16)
    return [np.asarray(a) for a in jnmf.nmf_m_step(x2, vs, w, h, g, mask, 1e-8)]


def write_jax_fixture():
    arrays = {f"{tag}_{name}": a for tag in ("bf16", "f32")
              for name, a in zip("whgv", _jax_m_step(tag))}
    os.makedirs(os.path.dirname(JAX_FIXTURE), exist_ok=True)
    np.savez_compressed(JAX_FIXTURE, **arrays)


def _jax_results(tag):
    with np.load(JAX_FIXTURE) as z:
        return [torch.from_numpy(z[f"{tag}_{name}"]) for name in "whgv"]


@pytest.mark.parametrize("tag", ["bf16", "f32"])
def test_jax_fixture_is_the_jax_m_step_and_the_plain_body_meets_it(tag):
    """The kept JAX results are what the JAX package gives (summation order
    only), and the CPU body meets them within the card tests' tolerance."""
    kept = _jax_results(tag)
    for name, a, b in zip("whgv", _jax_m_step(tag), kept):
        assert _rel(torch.from_numpy(np.array(a)), b) <= 1e-6, name
    tol = 1e-4 if tag == "bf16" else 1e-5
    for name, a, b in zip("WHgV", nmf.nmf_m_step(*_jax_case(tag)), kept):
        assert _rel(a, b) <= tol, (name, _rel(a, b))


# --- on the card ---------------------------------------------------------------

CARD_SHAPES = [  # (R, B, N, F, K, samples)
    (10, 32, 320, 513, 10, BF16),   # the offline cells
    (10, 32, 64, 513, 10, BF16),
    (10, 8, 320, 513, 10, BF16),    # the served cells
    (10, 1, 173, 513, 10, BF16),    # planes not of whole granules: not staged
    (30, 32, 320, 513, 10, BF16),   # m1_reference_effective's budget
    (10, 32, 320, 513, 10, F32),    # fast_stats off
    (1, 32, 320, 513, 10, F32),     # peem, run_em_fixed_z
    (1, 8, 160, 257, 1, F32),
    (10, 8, 160, 257, 37, BF16),
    (30, 8, 160, 513, 37, F32),
    (10, 1, 90, 257, 10, F32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=["x".join(map(str, s[:5])) + ("-bf16" if s[5] == BF16 else "-f32")
                              for s in CARD_SHAPES])
def test_cuda_kernel_matches_the_plain_body(cuda, shape):
    *dims, dtype = shape
    b = dims[1]
    args = _inputs(*dims, dtype, seed=3, silent=(b - 1,) if b > 1 else (), device=cuda)
    before = nmf.launches
    got = nmf.nmf_m_step(*args)
    assert nmf.launches - before == 3
    want = nmf.nmf_m_step_reference(*args)
    tol = 1e-4 if dtype == BF16 else 1e-5
    for name, a, b_ in zip("WHgV", got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b_) <= tol, (name, _rel(a, b_))


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["bf16", "f32"])
def test_cuda_kernel_matches_the_jax_m_step(cuda, tag):
    """The kernel against the JAX package's M-step on the same inputs
    (its kept results): relative L2 per utterance of W, H, g and Vb."""
    args = [t.to(cuda) for t in _jax_case(tag)]
    before = nmf.launches
    got = nmf.nmf_m_step(*args, 1e-8)
    assert nmf.launches - before == 3
    tol = 1e-4 if tag == "bf16" else 1e-5
    for name, a, b in zip("WHgV", got, _jax_results(tag)):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a.cpu(), b) <= tol, (name, _rel(a.cpu(), b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_cuda_repeated_calls_give_identical_bits(cuda, dtype):
    args = _inputs(10, 8, 320, 513, 10, dtype, seed=4, silent=(2,), device=cuda)
    one, two = nmf.nmf_m_step(*args), nmf.nmf_m_step(*args)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_cuda_every_layout_matches_the_plain_body(cuda):
    """The layouts the plan does not pick at this shape: staged and not,
    other warps and tiles, W in global memory; and a staged plan on planes
    that are not whole 16-byte granules is refused."""
    r, b, n, f, k = 10, 4, 96, 513, 10
    args = _inputs(r, b, n, f, k, BF16, seed=5, device=cuda)
    want = nmf.nmf_m_step_reference(*args)
    base = nmf.mstep_plan(r, b, n, f, k, BF16)
    for change in (dict(stage=False, warps2=8, tile2=16), dict(stage=True, warps2=4, tile2=12),
                   dict(stage=True, warps2=3, tile2=5), dict(w_smem2=False),
                   dict(tile1=7)):
        plan = base._replace(**change)
        tiles = -(-n // plan.tile1)
        plan = plan._replace(tiles=tiles, scratch=b * tiles * 2 * k * f + 2 * b * k * f + b * k)
        got = nmf._launch(*args, 1e-8, plan)
        for a, b_ in zip(got, want):
            assert _rel(a, b_) <= 1e-4, change
    odd = _inputs(r, 3, 173, f, k, BF16, seed=5, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        plan = nmf.mstep_plan(r, 3, 173, f, k, BF16)._replace(stage=True, warps2=4)
        nmf._launch(*odd, 1e-8, plan)


@pytest.mark.cuda
def test_cuda_plan_mirrors_the_kernels_shared_memory(cuda):
    lib = nmf.build_library()
    for r, f, k, dtype in ((10, 513, 10, BF16), (30, 513, 37, F32), (1, 257, 1, F32)):
        p = nmf.mstep_plan(r, 8, 320, f, k, dtype)
        vs_bytes = 2 if dtype == BF16 else 4
        assert lib.nmf_mstep_smem_bytes(1, r, f, k, vs_bytes, p.tile1, p.warps2, p.stage,
                                        p.fused, p.w_smem2) == p.smem1
        assert lib.nmf_mstep_smem_bytes(2, r, f, k, vs_bytes, p.tile1, p.warps2, p.stage,
                                        p.fused, p.w_smem2) == p.smem2


@pytest.mark.cuda
def test_cuda_no_pytorch_kernel_runs_inside_the_m_step(cuda):
    """Under torch.profiler, M-step calls run the three kernels of
    csrc/nmf_mstep.cu and nothing of at::native. Two calls are traced and
    the second is held whole: the card's tracer can miss the first kernels
    after it starts."""
    from torch.profiler import ProfilerActivity, profile

    args = _inputs(10, 8, 320, 513, 10, BF16, seed=6, device=cuda)
    nmf.nmf_m_step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            nmf.nmf_m_step(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
               if e.device_type == torch.autograd.DeviceType.CUDA and "emcpy" not in e.name
               and "emset" not in e.name]
    ours = ("mstep_w_partial", "mstep_w_finish", "mstep_h_g")
    assert all(any(o in n for o in ours) for n in kernels), kernels
    assert [o for n in kernels[-3:] for o in ours if o in n] == list(ours), kernels
    assert len(kernels) <= 6, kernels


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-jax-fixture"]:
        sys.exit("usage: test_torch_port_nmf_kernel.py --write-jax-fixture")
    write_jax_fixture()

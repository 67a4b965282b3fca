"""Engine-level faults for the readings of ``links_bad``'s upper end and for
the tests: each replaces the program's MCEM engine by a broken one whose
every stage still computes its own output right, so only the hand-overs
between the stages (``check._links``) can tell.

    with faults.planted("mstep_discarded"):
        harness.run(...)
"""

from __future__ import annotations

import contextlib
import dataclasses


def _mstep_discarded(orig):
    """``run_mcem`` that throws each M-step's (W, H, g) away: every E-step
    and the Wiener segment run on the initial NMF state."""
    from dvae_tpu_torch.enhance import mcem

    def engine(mats, x2, z_init, mask, seed=0, cfg=None, y=None, nmf_init=None):
        x2, mask, (w, h, g), mats, (g_em, g_wf), cfg = mcem._prep_em(mats, x2, mask, cfg, y,
                                                                     seed, nmf_init)
        b, n, f = x2.shape
        x2_r = mcem._stats(x2.reshape(b * n, f), cfg)
        z = z_init.float()
        for _ in range(cfg.niter):
            zf, vs = mcem._segment(mats, x2_r, mcem._stats(mcem.compute_vb(w, h), cfg), g, z,
                                   g_em, cfg.burnin_e_step, cfg.nsamples_e_step, cfg, False)
            z = zf.reshape(b, n, -1)
            mcem.nmf_m_step(x2, vs.reshape(cfg.nsamples_e_step, b, n, f), w, h, g, mask,
                            cfg.eps)
        wfs, wfn, z = mcem._wf_expectation(mats, x2_r, mask, z, w, h, g, g_wf, cfg)
        return mcem.McemResult(wfs, wfn, x2.new_zeros((0,)), z, w, h, g)
    return engine


def _niter_halved(orig):
    """The program's engine at half its ``niter`` (at least one)."""
    def engine(mats, x2, z_init, mask, seed=0, cfg=None, y=None, nmf_init=None):
        cfg = dataclasses.replace(cfg, niter=max(1, cfg.niter // 2))
        return orig(mats, x2, z_init, mask, seed, cfg, y=y, nmf_init=nmf_init)
    return engine


ENGINE_FAULTS = {"mstep_discarded": _mstep_discarded, "niter_halved": _niter_halved}


@contextlib.contextmanager
def planted(name: str, engine: str = "mcem"):
    """The program's ``engine`` replaced by the fault ``name`` while the
    block runs."""
    from dvae_tpu_torch.enhance import pipeline

    orig = pipeline.ENGINES[engine]
    pipeline.ENGINES[engine] = ENGINE_FAULTS[name](orig)
    try:
        yield
    finally:
        pipeline.ENGINES[engine] = orig

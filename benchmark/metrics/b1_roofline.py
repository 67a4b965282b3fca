"""The MH-chain kernel's (B1, ``csrc/mh_chain.cu``) share of its roofline:
the least time of each launch (``work.chain_work`` / ``chain_bound_ms`` at
its rows, budget, mode and body) over the device time of the kernels
named ``mh_chain_kernel`` in the trace."""

from benchmark import work
from benchmark.trace import kernel_ns


def read(run):
    spent = kernel_ns(run.events, "mh_chain_kernel") / 1e6
    if spent <= 0:
        return None
    bound = sum(work.chain_bound_ms(work.chain_work(rows, f, l, widths, n_burn, n_samples, wf,
                                                    fast_stats), fast_decoder)[0]
                for rows, f, l, widths, n_burn, n_samples, wf, fast_stats, fast_decoder
                in run.chain_calls)
    return 100.0 * bound / spent

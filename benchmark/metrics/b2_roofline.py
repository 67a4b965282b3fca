"""The STFT power kernel's (B2, ``csrc/stft_power.cu``) share of its
roofline: the least time of each launch (``work.stft_power_work``) over
the device time of the kernels named ``stft_power_kernel`` in the trace."""

from benchmark import work
from benchmark.trace import kernel_ns


def read(run):
    spent = kernel_ns(run.events, "stft_power_kernel") / 1e6
    if spent <= 0:
        return None
    bound = sum(work.bound_ms(*work.stft_power_work(rows, t, nfft, bins, False))[0]
                for rows, t, nfft, bins in run.power_calls)
    return 100.0 * bound / spent

"""The whole enhancement's share of the card's bf16 dense peak: the model
FLOPs of the valid frames answered in the window (``work.enhance_flops``)
over the window's seconds."""

from benchmark import work


def read(run):
    if not run.flops or not run.window_s:
        return None
    return 100.0 * run.flops / run.window_s / work.PEAK_BF16_FLOPS

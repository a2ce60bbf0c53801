"""Model FLOPs of the window's work (`portbench/flops.py`: the
products a step or call needs, nothing recomputed) over the window's
seconds times the card's dense bf16 peak, in percent."""
from portbench.flops import H100_BF16_PEAK


def read(run):
    w = run.window
    return 100.0 * w["flops"] / (w["seconds"] * H100_BF16_PEAK)

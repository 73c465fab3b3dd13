"""mfu.eval: the whole evaluation step's share of the card's bf16 peak.

The FLOP the traced window's completed steps and prefills needed, counted
by navbench/flops.py from the unpadded masks at the runner's boundary
(the LLM's layer products per token, attention over each row's real keys,
the panorama encoder, the fusion MLPs, the head), over the window's
seconds and 989 TFLOP/s (H100 SXM, dense bf16).
"""
from navbench.flops import PEAK_FLOPS


def read(t):
    if not t.get("flops") or t.get("window_s", 0) <= 0:
        return None
    return 100.0 * t["flops"] / (t["window_s"] * PEAK_FLOPS)

"""attn_roofline.eval: the flash-attention forward kernel's (K1) share of
its roofline.

The sum of fwd_bound (max of bytes over 3.35 TB/s and FLOP over 989
TFLOP/s) over the unpadded causal rows of every step and prefill in the
traced window, every layer, over the device time of K1's kernels in the
trace. Nothing where the window ran no K1 kernel (the prefix-cached cell's
steps attend through the eager window path).
"""


def read(t):
    if t.get("k1_s", 0) <= 0 or t.get("attn_bound_s", 0) <= 0:
        return None
    return 100.0 * t["attn_bound_s"] / t["k1_s"]

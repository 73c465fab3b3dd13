"""window_attn_ms_per_step.eval: the card's milliseconds per slot-group
step in the prefix-cached step's eager window attention.

The program's ``nav.window_attn`` spans (one per layer of each
``llama.chunk_forward_cached`` call), each timed by a pair of CUDA events
on the card's stream: the interval from the range's start to its end,
idle time inside it included; per slot-group step the program counted.
None where the window ran no cached step.
"""
from navbench.spans import ms_per_step


def read(t):
    return ms_per_step("window_attn", "device_s")

"""launch_ms_per_step.eval: host milliseconds per slot-group step spent
issuing the device work.

Every ``nav.launch`` span of the program, around
``device_memory.eval_step`` / ``eval_step_cached`` / ``prefill_prefix``
alone (the eager ATen launches of the step, the prefills' included); per
slot-group step the program counted.
"""
from navbench.spans import ms_per_step


def read(t):
    return ms_per_step("launch")

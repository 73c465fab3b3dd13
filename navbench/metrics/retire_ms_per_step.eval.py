"""retire_ms_per_step.eval: the host loop's own milliseconds retiring a
slot-group step.

The program's ``nav.retire`` span (``validate_streaming``'s ``_post``:
stop handling, refills, environment steps, observations) less the time
its nested spans of another layer covered, the runner's ``wait`` for the
step's actions; per slot-group step the program counted.
"""
from navbench.spans import ms_per_step


def read(t):
    return ms_per_step("retire", "self_s")

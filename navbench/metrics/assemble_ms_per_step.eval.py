"""assemble_ms_per_step.eval: the host loop's own milliseconds assembling
and dispatching a slot-group step.

The program's ``nav.assemble`` span (``validate_streaming``: the step's
host assembly and its dispatch, the queued prefills' included) less the
time its nested spans of another layer covered, the runner's ``upload``
and ``launch``; per slot-group step the program counted.
"""
from navbench.spans import ms_per_step


def read(t):
    return ms_per_step("assemble", "self_s")

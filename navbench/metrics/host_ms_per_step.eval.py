"""host_ms_per_step.eval: the host loop's milliseconds per slot-group step.

The traced window's wall time less the time the process spent inside the
benchmark's spans around calls into the program's runner (the step's
dispatch, the prefills, the wait for the step's actions), over the
slot-group steps completed in the window.
"""


def read(t):
    if not t.get("steps") or "runner_s" not in t:
        return None
    return 1e3 * (t["window_s"] - t["runner_s"]) / t["steps"]

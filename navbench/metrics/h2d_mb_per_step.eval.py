"""h2d_mb_per_step.eval: megabytes (1e6 bytes) sent to the card per
slot-group step: the program's ``h2d_bytes`` counter (each uploaded
array's bytes as uploaded, after any cast on the host) over the
slot-group steps it counted."""
from navbench.spans import per_step


def read(t):
    n = per_step("h2d_bytes")
    return None if n is None else n / 1e6

"""upload_ms_per_step.eval: host milliseconds per slot-group step spent
sending host arrays to the card.

Every ``nav.upload`` span of the program: the panorama assembly's feature
upload and each eval step's and prefill's gathered uploads (a pinned copy
and a non-blocking H2D copy per array); per slot-group step the program
counted.
"""
from navbench.spans import ms_per_step


def read(t):
    return ms_per_step("upload")

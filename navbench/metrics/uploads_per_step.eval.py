"""uploads_per_step.eval: host arrays sent to the card per slot-group
step: the program's ``uploads`` counter (one per
``NavModelRunner.upload``) over the slot-group steps it counted."""
from navbench.spans import per_step


def read(t):
    return per_step("uploads")

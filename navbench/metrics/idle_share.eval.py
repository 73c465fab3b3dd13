"""idle_share.eval: the share of the traced window in which no operation
ran on the card: 1 - (the union of its kernel, copy and memset spans) /
the window."""


def read(t):
    if t.get("window_s", 0) <= 0 or "busy_s" not in t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

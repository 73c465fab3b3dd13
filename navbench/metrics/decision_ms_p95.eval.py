"""decision_ms_p95.eval: the 95th percentile of the time a navigation
decision takes, in ms.

Over every slot-group step completed in the window after its traced part
(the profiler slows the steps it traces): from the step's start on the
host (the agent's prefetch call) to its actions back on the host. The
wait a deployed agent sees; a stall of the host loop (a refill, a
prefetch miss, a slow host) shows here and little in the rate.
"""
import statistics


def read(t):
    dec = t.get("decision_ms") or []
    if len(dec) < 20:
        return None
    return statistics.quantiles(dec, n=20, method="inclusive")[18]

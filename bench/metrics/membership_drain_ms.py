"""membership_drain_ms: the program's ``membership_drain`` span (host
clock, the service's own timing) summed over the traced window, a tick,
ms.  Nothing to read where the service keeps no such span."""


def read(run):
    if not run.spans or "membership_drain" not in run.spans:
        return None
    total, _ = run.spans["membership_drain"]
    return total / run.ticks * 1e3
